"""Per-clip orchestration on PyTorch: overlay videos from compiled scenes.

Counterpart of cama_tpu/pipeline.py's ClipPipeline and MultiScenePipeline.
A counting pass per source (ClipPipeline.overlay_mode) sizes the lists and
picks the serving mode, as the JAX package does: 'sparse' when a
per-camera point list of k entries costs fewer link bytes than the dense
raster, else 'raster'.

The sparse program (one per chunk of frames) ships each camera's
deduplicated kept points, compacted in paint order, to the host, which
paints them onto the base images; there is no device raster.  The dense
program turns the points into class rasters.  Both run the pipeline's
raster_kernel lane:

  'fused'    the fused CUDA kernel (project + crop + dedup + stable
             compaction, ops/fused_compact.py) -> union list, split per
             camera for the sparse lane
  'pallas'   the CUDA projection kernel (ops/pallas_project.py), then the
             per-camera dedup + stable compaction (ops/raster.py)
  'compact'  the same program with the plain projection (ops/geometry.py);
             dense: crop-first two-stage compaction when the crop culls
             at least half the points
  'scatter'  the plain projection; dense: every kept point scattered, no
             list

A dense list becomes rasters by a scatter-max at its centres and two
plus-stencil dilations (ops/raster.py); uint8 class rasters (2-bit packed
when the classes fit) go to the host, where base images are undistorted
once per frame and composited into the 3x2 video mosaic.  Every lane keeps
the same points and paints them in the same order, so all of them, sparse
or dense, give the same frames.  MultiScenePipeline serves several scenes'
dense rasters with one raster stage per chunk over all of them.

The device is explicit: `device='cuda'` runs the kernels and raises without
a card; `device='cpu'` runs the plain PyTorch versions (what the tests do).
The counting pass's maxima persist per clip in
.cama_tpu/overlay_counts.json, the file the JAX package uses, under keys of
this package's own (one per lane), so a later process skips the pass.
ClipPipeline.iter_overlay_rasters_exact is the bit-exact lane: the f32
projection with ambiguity flags, the flagged points recomputed on the host
in the reference's f64 chain and patched in before the raster.  The JAX
package's adaptive warm-up lane is not part of this package.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from cama_tpu_torch import native as _native
from cama_tpu_torch.io.frame_cache import FrameCache, frame_cache_key
from cama_tpu_torch.io.scene import (
    DEFAULT_CAMA_CONFIGS,
    Scene,
    compile_scene,
    pad_frames,
    scene_to_torch,
)
from cama_tpu_torch.io.video import CAMERA_GRID, VideoSink
from cama_tpu_torch.ops.fused_compact import (
    camera_counts,
    count_union,
    fused_compact_project,
    rasterize_from_union,
    sparse_from_union,
)
from cama_tpu_torch.ops.geometry import (
    compose_frame_matrices,
    crop_bounds,
    crop_compact_project,
    crop_mask,
    project_frame_exact,
    project_frames,
    project_frames_checked,
)
from cama_tpu_torch.ops.pallas_project import project_frame_pallas
from cama_tpu_torch.ops.raster import (
    CIRCLE_R2_OFFSETS,
    MAX_CLS,
    build_color_table,
    _encode_effective,
    compact_points,
    pack_cls_2bit,
    packed_to_cls,
    paint_sparse_host,
    rasterize_from_compact,
    rasterize_packed_fast,
    unpack_cls_2bit,
)
from cama_tpu_torch.ops.undistort import RemapCache, remap_host
from cama_tpu_torch.profiling import PhaseTimers

RASTER_KERNELS = ("fused", "pallas", "compact", "scatter", "auto")


def _host_project_chunk(points, valid, A, B, fv, width, height, lo, hi):
    """NumPy float64 projection of a chunk of frames (the host lane): same
    formulas and mask order as the device lanes.
    Returns (vu [F, C, P, 2] float32, keep [F, C, P] bool)."""
    points = np.asarray(points, np.float64)
    p4 = np.concatenate([points, np.ones_like(points[:, :1])], axis=-1)
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    valid = np.asarray(valid, bool)
    fv = np.asarray(fv, bool)
    xyz_ch = np.einsum("fij,pj->fpi", A[:, :3, :], p4)
    in_crop = ((xyz_ch >= np.asarray(lo, np.float64))
               & (xyz_ch <= np.asarray(hi, np.float64))).all(-1)
    xyw = np.einsum("fcij,pj->fcpi", B, p4)
    z = xyw[..., 2]
    mask_z = z > 0
    safe_z = np.where(mask_z, z, 1.0)
    u = xyw[..., 0] / safe_z
    v = xyw[..., 1] / safe_z
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    keep = (mask_z & in_img & in_crop[:, None, :]
            & valid[None, None, :] & fv[:, None, None])
    return np.stack([v, u], axis=-1).astype(np.float32), keep


def rasterize_cls_host(vu, keep, cls, width, height):
    """Host uint8 class raster with the device raster's semantics: floor to
    pixel, radius-2 L1 disk, later point (higher paint priority) wins —
    NumPy's point-major fancy assignment reproduces draw order.

    vu [C, P, 2] float32, keep [C, P], cls [P] -> [C, H, W] uint8 (cls+1,
    0 = empty)."""
    C = vu.shape[0]
    cls = np.asarray(cls)
    out = np.zeros((C, height, width), np.uint8)
    offs = np.asarray(CIRCLE_R2_OFFSETS)
    for c in range(C):
        idx = np.flatnonzero(keep[c])
        if len(idx) == 0:
            continue
        py = vu[c, idx, 0].astype(np.int32)
        px = vu[c, idx, 1].astype(np.int32)
        val = (cls[idx] % MAX_CLS + 1).astype(np.uint8)
        yy = py[:, None] + offs[None, :, 0]
        xx = px[:, None] + offs[None, :, 1]
        ok = (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
        flat = (yy * width + xx)[ok]
        vals = np.broadcast_to(val[:, None], yy.shape)[ok]
        out[c].reshape(-1)[flat] = vals
    return out


def _host_overlay_chunk(points, valid, cls, A, B, fv, lo, hi, width, height):
    """Host-lane overlay chunk: [chunk, C, H, W] uint8 class rasters in
    float64 (the anchor the device lanes are held against).  The crop mask
    is computed once per frame over P and the camera projection runs only
    on its survivors, in original order, so paint order is unchanged."""
    cls = np.asarray(cls)
    p64 = np.asarray(points, np.float64)
    p4 = np.concatenate([p64, np.ones_like(p64[:, :1])], axis=-1)
    xyz = np.einsum("fij,pj->fpi", np.asarray(A, np.float64)[:, :3, :], p4)
    in_crop = (((xyz >= np.asarray(lo, np.float64))
                & (xyz <= np.asarray(hi, np.float64))).all(-1)
               & np.asarray(valid, bool)[None, :]
               & np.asarray(fv, bool)[:, None])
    points = np.asarray(points)
    rasters = []
    for f in range(len(fv)):
        idx = np.flatnonzero(in_crop[f])
        vu, keep = _host_project_chunk(
            points[idx], np.ones(len(idx), bool), A[f:f + 1], B[f:f + 1],
            fv[f:f + 1], width, height, lo, hi)
        rasters.append(
            rasterize_cls_host(vu[0], keep[0], cls[idx], width, height))
    return np.stack(rasters)


def _chunk_lists(lane, points, valid, cls, A, B, frame_valid, crop_lo,
                 crop_hi, width, height, k):
    """The list half of a lane's dense program over one chunk of F frames:
    'fused' -> (union list [F, k, C], union count [F]) from the fused
    kernel; 'pallas'/'compact' -> (per-camera lists [F, C, k], the largest
    per-camera count [F]) from the lane's projection and compact_points.
    Counts are true totals, so count > k reports an overflowed list."""
    if lane == "fused":
        return fused_compact_project(points, valid, cls, A, B, frame_valid,
                                     width, height, crop_lo, crop_hi, k)
    vu, keep = _LANE_PROJECTIONS[lane](points, valid, A, B, frame_valid,
                                       width, height, crop_lo, crop_hi)
    vals, counts = compact_points(vu, keep, cls, width, height, k)
    return vals, counts.amax(-1)


def _lists_to_rasters(lane, vals, count, width, height, two_bit):
    """The raster half: a scatter-max at the lists' centres, the two
    dilations, then uint8 class rasters [..., C, H, W] (2-bit packed
    [..., C, H, ceil(W/4)] when two_bit).  Any leading batch shape."""
    packed = (rasterize_from_union(vals, count, width, height)
              if lane == "fused" else rasterize_from_compact(vals, width, height))
    rasters = packed_to_cls(packed)
    return pack_cls_2bit(rasters) if two_bit else rasters


def _overlay_chunk_lists(lane, points, valid, cls, A, B, frame_valid, crop_lo,
                         crop_hi, width, height, k, two_bit):
    """A list lane's dense program: one chunk of F frames -> (class
    rasters, and the list counts [F] to hold against k)."""
    vals, count = _chunk_lists(lane, points, valid, cls, A, B, frame_valid,
                               crop_lo, crop_hi, width, height, k)
    return _lists_to_rasters(lane, vals, count, width, height, two_bit), count


# 'fused': the fused CUDA kernel (k = the union cap); 'pallas': one launch
# of the CUDA projection kernel per chunk, then compaction; 'compact'
# (single stage): the 'pallas' program with the plain projection
_overlay_chunk_fused = partial(_overlay_chunk_lists, "fused")
_overlay_chunk_pallas = partial(_overlay_chunk_lists, "pallas")
_overlay_chunk_compact = partial(_overlay_chunk_lists, "compact")


def _overlay_chunk_two_stage(points, valid, cls, A, B, frame_valid, crop_lo,
                             crop_hi, width, height, k1, k2, two_bit):
    """The 'compact' lane with crop-first compaction: the crop test is
    camera-independent, so each frame's crop survivors are compacted once
    to k1 slots, and the per-camera dedup and compaction run over k1
    entries instead of P.  Both compactions are stable, so the rasters equal
    the single-stage lane's.  Returns (rasters, counts [F, 2]: the crop
    count, held against k1, and the largest per-camera count, against
    k2)."""
    vu, keep, cls_sel, n_crop = crop_compact_project(
        points, valid, cls, A, B, frame_valid, width, height, crop_lo,
        crop_hi, k1)
    vals, counts = compact_points(vu, keep, cls_sel[:, None, :], width,
                                  height, k2)
    rasters = _lists_to_rasters("compact", vals, None, width, height, two_bit)
    return rasters, torch.stack([n_crop, counts.amax(-1)], dim=-1)


def _overlay_chunk(points, valid, cls, A, B, frame_valid, crop_lo, crop_hi,
                   width, height, two_bit):
    """The 'scatter' lane: the plain projection, then every kept point
    scattered at its centre (no compaction).  Returns (rasters, the largest
    per-camera kept count [F], which is at most P)."""
    vu, keep = project_frames(points, valid, A, B, frame_valid, width, height,
                              crop_lo, crop_hi)
    rasters = packed_to_cls(rasterize_packed_fast(vu, keep, cls, width,
                                                  height))
    kept = keep.sum(dim=-1, dtype=torch.int32).amax(-1)
    return (pack_cls_2bit(rasters) if two_bit else rasters), kept


def _exact_patch_raster_chunk(vu, keep, cls, ids, corr_vu, corr_keep,
                              corr_valid, width, height, k):
    """Patch host-recomputed exact values into a chunk's projection and
    rasterize (the exact lane's second device pass).

    vu [F, C, P, 2] / keep [F, C, P]: the checked projection's outputs.
    ids [F, M] int point indices; slots with corr_valid [F, M] false are
    dropped (they are scattered into a row P past the points, which is
    sliced away).  corr_vu [F, C, M, 2] carries floor(exact) + 0.5 pixel
    centres (truncation-safe), corr_keep [F, C, M] the exact keep masks.
    Patched points retain their point index, so compact_points' paint order
    is untouched.  Returns (class rasters [F, C, H, W] uint8, the largest
    effective count, a 0-d tensor the caller holds against k)."""
    F, C, P = keep.shape
    idx = torch.where(corr_valid, ids.to(torch.int64), P)[:, None, :]
    idx = idx.expand(F, C, idx.shape[-1])
    vu_p = torch.nn.functional.pad(vu, (0, 0, 0, 1))
    vu_p.scatter_(2, idx[..., None].expand(*idx.shape, 2), corr_vu)
    keep_p = torch.nn.functional.pad(keep, (0, 1))
    keep_p.scatter_(2, idx, corr_keep)
    vals, counts = compact_points(vu_p[:, :, :P], keep_p[:, :, :P], cls,
                                  width, height, k)
    return (packed_to_cls(rasterize_from_compact(vals, width, height)),
            counts.max())


def _project_compact_chunk(points, valid, cls, A, B, frame_valid, crop_lo,
                           crop_hi, width, height, k, lane="compact",
                           k_cap=None):
    """The sparse program over one chunk of F frames: per (frame, camera),
    the deduplicated kept points compacted to k slots in paint order, with
    no raster.  'fused' runs the fused kernel at the union cap k_cap and
    splits its union list per camera (ops.fused_compact.sparse_from_union);
    'pallas' runs the CUDA projection kernel, the other lanes the plain
    projection (the JAX package's program), each then compact_points.

    Returns (vals [F, C, k] int32, counts [F, C] int32 — count > k: the
    frame falls back to its dense raster — and, for 'fused', the union
    count [F], held against k_cap; None for the other lanes)."""
    if lane == "fused":
        union, count = fused_compact_project(points, valid, cls, A, B,
                                             frame_valid, width, height,
                                             crop_lo, crop_hi, k_cap)
        return (*sparse_from_union(union, count, k), count)
    vu, keep = _LANE_PROJECTIONS.get(lane, project_frames)(
        points, valid, A, B, frame_valid, width, height, crop_lo, crop_hi)
    return (*compact_points(vu, keep, cls, width, height, k), None)


_LANE_PROJECTIONS = {"pallas": project_frame_pallas,
                     "compact": project_frames}


def _fetch_async(tensors, on_card):
    """Queue the copies of `tensors` into pinned host buffers with one CUDA
    event marking their arrival: (host tensors, event).  CPU tensors are
    handed through with no event."""
    if not on_card:
        return tuple(tensors), None
    hosts = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                  for t in tensors)
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return hosts, done


def _check_lists(label, lane, s, count, limit):
    """Raise when a frame of the chunk starting at frame s keeps more list
    rows than its list holds.  count [F] or [F, n] against limit, a size or
    n sizes."""
    over = np.asarray(count > limit).reshape(len(count), -1).any(-1)
    if over.any():
        f = int(np.argmax(over))
        raise RuntimeError(
            f"{label}: frame {s + f} keeps {count[f]} list rows, over the "
            f"{lane} list size k={limit}")


def _close_all_sinks(sinks):
    """Close every sink even when one close() raises; re-raise the first
    failure after all encoders have been released."""
    first = None
    for s in sinks.values():
        try:
            s.close()
        except Exception as e:
            if first is None:
                first = e
    if first is not None:
        raise first


def _pow2_cap(n, P):
    """List size k: the power of two >= n, at least 1024 and at most P."""
    k = 1024
    while k < n:
        k *= 2
    return min(k, max(P, 1))


class ClipPipeline:
    def __init__(self, configs=None, clip_path=None, sources=("cama", "nuscenes"),
                 chunk=8, scene: Scene = None, raster_kernel=None,
                 device="cuda"):
        """raster_kernel: the device lane (module docstring): 'fused',
        'pallas', 'compact', 'scatter' or 'auto'; the constructor argument
        wins, then configs['raster_kernel'], then 'fused'.  'auto' serves
        'fused', the JAX package's production preference once its warm-up
        is done: cama_tpu's 'auto' streams a host lane only to hide XLA's
        compile wall, and PyTorch runs eagerly with no such wall.
        device: 'cuda' runs the CUDA kernels and raises
        when no card is present; 'cpu' runs their plain PyTorch
        versions."""
        self.configs = {**DEFAULT_CAMA_CONFIGS, **(configs or {})}
        if raster_kernel is None:  # ctor arg > config key > default
            raster_kernel = self.configs.get("raster_kernel") or "fused"
        if raster_kernel not in RASTER_KERNELS:
            raise ValueError(
                f"unknown raster_kernel {raster_kernel!r}; expected one of "
                f"{', '.join(map(repr, RASTER_KERNELS))}")
        self.raster_kernel = "fused" if raster_kernel == "auto" else raster_kernel
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self.chunk = int(chunk)
        if scene is not None:
            self.scene = scene
        else:
            cache = None
            if self.configs.get("scene_cache", True) and clip_path is not None:
                cache_dir = self.configs.get("scene_cache_dir")
                if cache_dir:  # shared dir: keep per-clip files distinct
                    clip_slug = os.path.basename(os.path.normpath(str(clip_path)))
                    cache = os.path.join(cache_dir, f"{clip_slug}_scene_cache.npz")
                else:
                    cache = os.path.join(str(clip_path), ".cama_tpu",
                                         "scene_cache.npz")
            self.scene = compile_scene(clip_path, self.configs, sources=sources,
                                       cache=cache)
        self.remaps = RemapCache()
        self.timers = PhaseTimers()
        self._fcache = False  # False = not yet resolved (None = disabled)
        self._fcache_lock = threading.Lock()
        self._fm = {}
        self._dev = {}
        self._mode = {}       # source -> ('sparse' | 'raster', k)
        self._fused_k = {}    # source -> the fused kernel's union cap
        self._two_stage = {}  # source -> k1 of the two-stage split, or None
        self._k = {}          # source -> the lane's dense list size
        # one entry per chunk the exact lane served: its patch size M and
        # the flagged points of each real frame
        self.exact_stats = []
        self._crop_lo, self._crop_hi = crop_bounds()
        self._color_tables = {
            src: build_color_table(self.scene.flat[src].class_names)
            for src in self.scene.flat
        }

    # ---------------- cached per-source state ----------------

    def frame_matrices(self, source, t_max_diff=0.5):
        key = (source, t_max_diff)
        if key not in self._fm:
            self._fm[key] = compose_frame_matrices(
                self.scene.traj[source],
                self.scene.frame_times,
                self.scene.chassis2cam,
                self.scene.K_scaled,
                t_max_diff=t_max_diff,
            )
        return self._fm[key]

    def scene_tensors(self, source):
        """io.scene.SceneTensors of `source` on this pipeline's device."""
        if source not in self._dev:
            self._dev[source] = scene_to_torch(
                self.scene, source, self.device, self.frame_matrices(source),
                self.chunk)
        return self._dev[source]

    def device_points(self, source):
        """(points [P,3] f32, cls [P] i32, valid [P] bool) on the device."""
        st = self.scene_tensors(source)
        return st.points, st.cls, st.valid

    def _chunked_AB(self, source):
        """(FrameMatrices, A, B, frame_valid padded to a multiple of the
        chunk as float32/bool host arrays, number of real frames)."""
        fm = self.frame_matrices(source)
        A, B, fv = pad_frames(fm, self.chunk)
        return fm, A, B, fv, len(fm.frame_indices)

    # ---------------- device passes ----------------

    def overlay_mode(self, source):
        """('sparse' or 'raster', k), from a counting pass over every chunk:
        the JAX package's decision (cama_tpu/pipeline.py:overlay_mode and
        _finish_overlay_mode) on the port's own counts.

        The pass measures the three maxima over frames of the JAX
        _count_chunk: the crop count, the largest per-camera effective
        (deduplicated) count mc and the union count over cameras, with this
        lane's projection.  On 'fused', count_union sizes one
        fused_compact_project launch per chunk whose union list gives the
        per-camera counts; the other lanes project all P points.  Then
        k = pow2(mc) (the power of two >= mc, at least 1024, at most P);
        the fused kernel's union cap _fused_k = pow2(union); the two-stage
        split _two_stage = pow2(crop) when that culls at least half the
        points, else None; and 'sparse' when k * 4 bytes per camera beat the
        dense raster's bytes on the link.  _k is the list size of the
        lane's dense program: the union cap for 'fused', k for 'pallas' and
        'compact', P for 'scatter', which has no list.

        With configs['scene_cache'] (default on) the three maxima persist in
        .cama_tpu/overlay_counts.json under _counts_sidecar_key, and a later
        pipeline or process on the same clip and lane skips the pass."""
        if source in self._mode:
            return self._mode[source]
        entry = self._counts_sidecar(source)
        maxima = entry and self._counts_sidecar_load(*entry)
        if maxima is None:
            maxima = self._count_maxima(source)
            if entry is not None:
                self._counts_sidecar_store(*entry, *maxima)
        return self._finish_overlay_mode(source, *maxima)

    def _count_maxima(self, source):
        """The counting pass (overlay_mode): (mc_crop, mc, mc_union)."""
        st = self.scene_tensors(source)
        P = int(st.points.shape[0])
        h, w = self.scene.output_size
        geo = (w, h, self._crop_lo, self._crop_hi)
        chunks = [slice(s, s + self.chunk)
                  for s in range(0, st.A.shape[0], self.chunk)]

        def frames(sl):
            return (st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                    st.frame_valid[sl])

        crop = torch.cat([
            crop_mask(st.points, st.valid, st.A[sl], st.frame_valid[sl],
                      self._crop_lo, self._crop_hi).sum(-1, dtype=torch.int32)
            for sl in chunks])
        if self.raster_kernel == "fused":
            union = torch.cat([count_union(*frames(sl), *geo) for sl in chunks])
            cap = _pow2_cap(int(union.max()), P)
            per_cam = torch.cat([
                camera_counts(*fused_compact_project(*frames(sl), *geo, cap))
                for sl in chunks])
        else:
            proj = _LANE_PROJECTIONS.get(self.raster_kernel, project_frames)
            per_cam, union = [], []
            for sl in chunks:
                points, valid, cls, A, B, fv = frames(sl)
                vu, keep = proj(points, valid, A, B, fv, *geo)
                _, eff = _encode_effective(vu, keep, cls, w, h)
                per_cam.append(eff.sum(-1, dtype=torch.int32))
                union.append(eff.any(-2).sum(-1, dtype=torch.int32))
            per_cam, union = torch.cat(per_cam), torch.cat(union)
        return tuple(int(v) for v in torch.stack(
            [crop.max(), per_cam.max(), union.max()]).tolist())

    def _counts_sidecar(self, source):
        """(path, key) of this source's entry in the clip's counts sidecar,
        or None when configs['scene_cache'] is off (nothing is read or
        written then)."""
        if not self.configs.get("scene_cache", True):
            return None
        return (os.path.join(self._cache_dir(), "overlay_counts.json"),
                self._counts_sidecar_key(source))

    def _counts_sidecar_key(self, source):
        """Everything that determines the counting pass's maxima: the point
        tensors, the frame matrices (trajectory + calibration + sync), the
        crop box and the output size, as the JAX package hashes them, plus
        this package's name and the lane.  The maxima come from the lane's
        own projection, so neither package reads the other's entry and no
        lane reads another's; both packages share the file and ignore the
        keys they do not know."""
        fm = self.frame_matrices(source)
        fp = self.scene.flat[source]
        h = hashlib.sha256()
        for arr in (fp.points, fp.valid, fp.cls, fm.A, fm.B, fm.frame_valid,
                    self._crop_lo, self._crop_hi):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(repr((source, tuple(self.scene.output_size))).encode())
        h.update(repr(("cama_tpu_torch", self.raster_kernel)).encode())
        return h.hexdigest()

    @staticmethod
    def _counts_sidecar_load(path, key):
        """(mc_crop, mc, mc_union) stored under `key`, or None."""
        try:
            with open(path) as f:
                entry = json.load(f).get(key)
            if not entry or len(entry) != 3:
                return None
            return tuple(int(v) for v in entry)
        except (OSError, ValueError, TypeError, AttributeError):
            return None

    @staticmethod
    def _counts_sidecar_store(path, key, mc_crop, mc, mc_union):
        """Add the entry, keep the 32 most recent, and replace the file
        atomically.  An unwritable clip directory is not an error: the
        counts are measured again next time."""
        try:
            data = {}
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        data = json.load(f)
                except (OSError, ValueError):
                    data = {}
            data[key] = [int(mc_crop), int(mc), int(mc_union)]
            if len(data) > 32:
                data = dict(list(data.items())[-32:])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, path)
        except OSError:
            pass

    def crop_compact_k(self, source):
        """k1 of the crop-first split when the counting pass engaged it, else
        None: the sizing the overlay lanes use, for callers that bound
        per-point work with it (map evaluation).  Consults only what is
        already known, this process's counting result or the sidecar, and
        never runs the counting pass itself: compaction stays off until an
        overlay pass has sized the clip."""
        if source not in self._mode:
            entry = self._counts_sidecar(source)
            maxima = entry and self._counts_sidecar_load(*entry)
            if maxima is None:
                return None
            self._finish_overlay_mode(source, *maxima)
        return self._two_stage.get(source)

    def _finish_overlay_mode(self, source, mc_crop, mc, mc_union):
        """The counting maxima -> the (mode, k) decision, the union cap, the
        two-stage split and the dense list size (overlay_mode)."""
        h, w = self.scene.output_size
        P = int(self.scene.flat[source].points.shape[0])
        k = _pow2_cap(mc, P)
        k1 = _pow2_cap(mc_crop, P)
        self._fused_k[source] = _pow2_cap(mc_union, P)
        # crop-first two-stage pays when the crop culls at least half the
        # points (the JAX package's rule)
        self._two_stage[source] = k1 if k1 * 2 <= P else None
        self._k[source] = {"fused": self._fused_k[source],
                           "scatter": P}.get(self.raster_kernel, k)
        C = len(self.scene.camera_list)
        # dense raster link cost: 2-bit packing only fits <= 3 class ids
        dense_bytes = h * w * C // 4 if self._use_2bit(source) else h * w * C
        self._mode[source] = ("sparse" if k * 4 * C < dense_bytes
                              else "raster", k)
        return self._mode[source]

    def serving_mode(self, source):
        """The mode write_videos and iter_frames serve: overlay_mode (the
        JAX package's 'auto' warm-up lane is not ported: PyTorch has no
        compile wall to hide)."""
        return self.overlay_mode(source)

    def _use_2bit(self, source):
        fp = self.scene.flat[source]
        max_cls = int(fp.cls[fp.valid].max()) if fp.valid.any() else 0
        return max_cls <= 2  # raster values cls+1 must fit in 2 bits

    def _dense_program(self, source, two_bit):
        """(run, limit): run(frame slice) -> (class rasters, list counts) of
        this lane's dense program over those frames, and the list size(s)
        the counts are held against.  'compact' goes two-stage when the
        counting pass engaged the split (k1, then k2 = min(k, k1))."""
        st = self.scene_tensors(source)
        h, w = self.scene.output_size
        self.overlay_mode(source)
        lane, k = self.raster_kernel, self._k[source]
        k1 = self._two_stage[source] if lane == "compact" else None

        def run(sl):
            args = (st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                    st.frame_valid[sl], self._crop_lo, self._crop_hi, w, h)
            if lane == "scatter":
                return _overlay_chunk(*args, two_bit)
            if k1 is not None:
                return _overlay_chunk_two_stage(*args, k1, min(k, k1), two_bit)
            return _overlay_chunk_lists(lane, *args, k, two_bit)

        return run, (k if k1 is None else np.asarray([k1, min(k, k1)]))

    def iter_overlay_rasters(self, source, max_in_flight=16, unpack=True):
        """Yield (image_idx, cls_raster [C, H, W] uint8 on host) per valid
        frame, from the lane's dense program.  Chunks are queued on the
        device ahead of consumption; each chunk's rasters and counts are
        copied into pinned host buffers with non_blocking copies, one CUDA
        event per chunk marks their arrival, and at most `max_in_flight`
        chunks are pending at once.  Every frame's list count is checked
        against the lane's list size when its chunk is drained (an
        overflowed list raises).

        unpack=False hands the 2-bit packed [C, H, ceil(W/4)] format
        through untouched (when the scene uses it) — the native mosaic
        compositor decodes it during the paint pass."""
        fm, _, _, _, F = self._chunked_AB(source)
        st = self.scene_tensors(source)
        w = self.scene.output_size[1]
        run, limit = self._dense_program(source, self._use_2bit(source))
        on_card = self.device.type == "cuda"

        def dispatch(sl):
            with self.timers.phase("device_dispatch"):
                return _fetch_async(run(sl), on_card)

        def drain(entry):
            s, ((rasters, count), done) = entry
            with self.timers.phase("raster_fetch"):
                if done is not None:
                    done.synchronize()
                _check_lists(source, self.raster_kernel, s, count.numpy(),
                             limit)
                rasters = rasters.numpy()
                if unpack and rasters.shape[-1] != w:
                    rasters = unpack_cls_2bit(rasters, w)  # [chunk, C, H, W]
            return [(int(fm.frame_indices[s + j]), rasters[j])
                    for j in range(rasters.shape[0])
                    if s + j < F and fm.frame_valid[s + j]]

        pending = []
        for s in range(0, st.A.shape[0], self.chunk):
            pending.append((s, dispatch(slice(s, s + self.chunk))))
            if len(pending) >= max_in_flight:
                yield from drain(pending.pop(0))
        for entry in pending:
            yield from drain(entry)

    def iter_sparse_points(self, source, k=None, max_in_flight=16):
        """The scatter-free stream: yields (image_idx, vals [C, k] int32,
        counts [C]) per valid frame from the lane's sparse program
        (_project_compact_chunk), with the copies of iter_overlay_rasters
        (pinned, non_blocking, one CUDA event per chunk) under the phase
        'sparse_fetch'.  A count > k means that camera's list overflowed:
        the caller paints that frame from its dense raster
        (_overlay_single).  On 'fused', the union list is held against its
        cap at drain, and an overflow raises.  k defaults to the JAX
        package's budget of about P / 3."""
        fm, _, _, _, F = self._chunked_AB(source)
        st = self.scene_tensors(source)
        h, w = self.scene.output_size
        P = int(st.points.shape[0])
        if k is None:
            k = min(P, max(4096, -(-(P // 3) // 1024) * 1024))
        self.overlay_mode(source)
        lane, k_cap = self.raster_kernel, self._fused_k[source]
        on_card = self.device.type == "cuda"

        def dispatch(sl):
            with self.timers.phase("device_dispatch"):
                vals, counts, union = _project_compact_chunk(
                    st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                    st.frame_valid[sl], self._crop_lo, self._crop_hi, w, h,
                    k, lane=lane, k_cap=k_cap)
                out = (vals, counts) if union is None else (vals, counts, union)
                return _fetch_async(out, on_card)

        def drain(entry):
            s, (out, done) = entry
            with self.timers.phase("sparse_fetch"):
                if done is not None:
                    done.synchronize()
                if len(out) == 3:
                    _check_lists(source, lane, s, out[2].numpy(), k_cap)
                vals, counts = out[0].numpy(), out[1].numpy()
            return [(int(fm.frame_indices[s + j]), vals[j], counts[j])
                    for j in range(vals.shape[0])
                    if s + j < F and fm.frame_valid[s + j]]

        pending = []
        for s in range(0, st.A.shape[0], self.chunk):
            pending.append((s, dispatch(slice(s, s + self.chunk))))
            if len(pending) >= max_in_flight:
                yield from drain(pending.pop(0))
        for entry in pending:
            yield from drain(entry)

    def _overlay_single(self, source, image_idx):
        """The dense class raster [C, H, W] uint8 of one frame, from the
        lane's own dense program on a one-frame slice: the fallback for a
        frame whose sparse list overflowed."""
        fm = self.frame_matrices(source)
        i = int(np.flatnonzero(fm.frame_indices == image_idx)[0])
        run, limit = self._dense_program(source, False)
        raster, count = run(slice(i, i + 1))
        _check_lists(source, self.raster_kernel, i, count.cpu().numpy(), limit)
        return raster[0].cpu().numpy()

    def iter_overlay_rasters_host(self, source):
        """Pure-host overlay stream in float64: (image_idx, cls_raster
        [C, H, W] uint8) per valid frame, with no device work at all."""
        fm, A, B, fv, F = self._chunked_AB(source)
        fp = self.scene.flat[source]
        h, w = self.scene.output_size
        for s in range(0, len(fv), self.chunk):
            sl = slice(s, s + self.chunk)
            rasters = _host_overlay_chunk(
                fp.points, fp.valid, fp.cls, A[sl], B[sl], fv[sl],
                self._crop_lo, self._crop_hi, w, h)
            for kk in range(rasters.shape[0]):
                fidx = s + kk
                if fidx >= F or not fm.frame_valid[fidx]:
                    continue
                yield int(fm.frame_indices[fidx]), rasters[kk]

    def iter_overlay_rasters_exact(self, source, patch_cap_min=512):
        """The bit-exact overlay stream: yields (image_idx, cls_raster
        [C, H, W] uint8 on host) like iter_overlay_rasters, with rasters
        bitwise equal to the float64 host-exact lane (project_frame_exact
        + cv2.circle) and so to the reference renderer.

        Per chunk, project_frames_checked projects every point in f32 and
        flags those whose keep guards or pixel floor sit within the f32
        error of a decision boundary (a handful per frame).  Only the
        flagged points are recomputed on the host in the reference's f64
        chain and patched into the device arrays before the compaction and
        raster pass (_exact_patch_raster_chunk); everything unflagged
        quantizes as the f64 chain does.  Lists hold k_compact + M rows,
        M the chunk's patch size; an overflow raises."""
        fm, _, _, fv, F = self._chunked_AB(source)
        st = self.scene_tensors(source)
        B_lo = torch.from_numpy(self.exact_B_lo(source)).to(self.device)
        pts_np = self.scene.flat[source].points
        P = int(st.points.shape[0])
        C = len(self.scene.camera_list)
        h, w = self.scene.output_size
        _, k_compact = self.overlay_mode(source)

        for s in range(0, len(fv), self.chunk):
            sl = slice(s, s + self.chunk)
            with self.timers.phase("exact_project"):
                vu, keep, amb = project_frames_checked(
                    st.points, st.valid, st.A[sl], st.B[sl], B_lo[sl],
                    st.frame_valid[sl], w, h, self._crop_lo, self._crop_hi)
                amb_np = amb.cpu().numpy()
            n_frames = amb_np.shape[0]
            n_amb = int(amb_np.sum(axis=1).max())
            M = patch_cap_min
            while M < n_amb:
                M *= 2
            if M > P:
                raise RuntimeError(
                    f"{source}: exact lane: {n_amb} ambiguous points need a "
                    f"patch of {M}, over the point count {P}")
            with self.timers.phase("exact_host_patch"):
                ids = np.full((n_frames, M), P, np.int64)
                corr_vu = np.full((n_frames, C, M, 2), 0.5, np.float32)
                corr_keep = np.zeros((n_frames, C, M), bool)
                corr_valid = np.zeros((n_frames, M), bool)
                for f in range(n_frames):
                    fidx = s + f
                    if fidx >= F or not fm.frame_valid[fidx]:
                        continue
                    pid = np.flatnonzero(amb_np[f])
                    n = len(pid)
                    if n == 0:
                        continue
                    ids[f, :n] = pid
                    corr_valid[f, :n] = True
                    # the reference's exact f64 chain, the same call as
                    # validate.host_exact_frames
                    cam_outs = project_frame_exact(
                        pts_np[pid],
                        np.linalg.inv(fm.chassis2world_f32[fidx]),
                        self.scene.chassis2cam, self.scene.K_scaled, w, h)
                    for c, (vu_e, keep_e) in enumerate(cam_outs):
                        with np.errstate(invalid="ignore"):
                            q = np.floor(np.nan_to_num(
                                vu_e, nan=0.0, posinf=0.0, neginf=0.0)) + 0.5
                        corr_vu[f, c, :n] = np.where(keep_e[:, None], q, 0.5)
                        corr_keep[f, c, :n] = keep_e
            k_total = k_compact + M
            with self.timers.phase("device_dispatch"):
                rasters, cnt_max = _exact_patch_raster_chunk(
                    vu, keep, st.cls,
                    *(torch.from_numpy(a).to(self.device)
                      for a in (ids, corr_vu, corr_keep, corr_valid)),
                    w, h, k_total)
            with self.timers.phase("raster_fetch"):
                cnt_max = int(cnt_max)
                if cnt_max > k_total:
                    raise RuntimeError(
                        f"{source}: exact lane: a frame of the chunk at "
                        f"frame {s} keeps {cnt_max} list rows, over the "
                        f"list size k={k_total}")
                rasters = rasters.cpu().numpy()
            self.exact_stats.append(
                {"M": M, "flagged": amb_np.sum(axis=1)[:F - s].tolist()})
            for f in range(n_frames):
                fidx = s + f
                if fidx >= F or not fm.frame_valid[fidx]:
                    continue
                yield int(fm.frame_indices[fidx]), rasters[f]

    def exact_B_lo(self, source):
        """[Fp, C, 3, 4] float32: what the f32 cast of the f64-composed B
        rounded away (~1e-3 px of u/v under cancellation), padded like
        _chunked_AB's B.  It rides along with B so the compensated
        re-projection of project_frames_checked reconstructs the
        full-precision value."""
        fm, _, B, _, F = self._chunked_AB(source)
        B64 = np.zeros(B.shape, np.float64)
        B64[:F] = fm.B
        return (B64 - B.astype(np.float64)).astype(np.float32)

    def project_source(self, source):
        """All frames' (vu, keep) as tensors on the device (for metrics and
        export).  Memory: F * C * P entries; chunk by hand when that does
        not fit."""
        fm, _, _, _, F = self._chunked_AB(source)
        st = self.scene_tensors(source)
        h, w = self.scene.output_size
        vu, keep = project_frames(st.points, st.valid, st.A, st.B,
                                  st.frame_valid, w, h, self._crop_lo,
                                  self._crop_hi)
        return fm, vu[:F], keep[:F]

    # ---------------- host compositing ----------------

    def frame_cache(self):
        """The per-clip pre-undistorted frame store (io.frame_cache),
        resolved lazily; disabled with configs['frame_cache']=False."""
        if self._fcache is False:
            with self._fcache_lock:
                if self._fcache is False:
                    self._fcache = self._build_frame_cache()
        return self._fcache

    def _cache_dir(self):
        scene = self.scene
        cache_dir = self.configs.get("frame_cache_dir")
        if cache_dir:  # shared dir: keep per-clip stores distinct
            return os.path.join(
                cache_dir, os.path.basename(os.path.normpath(scene.clip_path)))
        return os.path.join(scene.clip_path, ".cama_tpu")

    def _build_frame_cache(self):
        scene = self.scene
        if not self.configs.get("frame_cache", True):
            return None
        key = frame_cache_key(
            scene.camera_list, scene.output_size, scene.K_orig,
            scene.d, scene.K_scaled, scene.sync_ms,
        )
        if self.configs.get("fast_decode"):
            key = "fast2:" + key  # reduced-decode pixels differ
        return FrameCache.open(
            self._cache_dir(), len(scene.frame_times), len(scene.camera_list),
            scene.output_size, key,
            write_budget=self.configs.get("frame_cache_budget"),
        )

    def _decode_remap(self, camera, c, image_idx):
        """cv2 decode + cached-grid remap for one (camera, frame), byte-exact
        to the reference's undistorted image; configs['fast_decode'] decodes
        at half resolution instead (not byte-identical)."""
        import cv2

        h, w = self.scene.output_size
        path = self.scene.image_path(camera, image_idx)
        if not os.path.exists(path):
            raise FileNotFoundError(f"camera image missing: {path}")
        if self.configs.get("fast_decode"):
            img = cv2.imread(path, cv2.IMREAD_REDUCED_COLOR_2)
            mapx, mapy = self.remaps.get_scaled(
                (camera, 2), self.scene.K_orig[c], self.scene.d[c],
                self.scene.K_scaled[c], (h, w), 2,
            )
        else:
            img = cv2.imread(path)
            mapx, mapy = self.remaps.get(
                camera, self.scene.K_orig[c], self.scene.d[c],
                self.scene.K_scaled[c], (h, w),
            )
        if img is None:
            raise FileNotFoundError(
                f"camera image missing or unreadable: {path}")
        return remap_host(img, mapx, mapy)

    def undistorted_image(self, camera, image_idx, copy=True):
        """Undistorted base image. Cache hits return mmap-backed pixels:
        a mutable copy by default; pass copy=False when the caller promises
        not to paint on the array."""
        c = self.scene.camera_list.index(camera)
        fc = self.frame_cache()
        if fc is not None:
            cached = fc.get(image_idx, c)
            if cached is not None:
                return np.array(cached, copy=True) if copy else cached
        img = self._decode_remap(camera, c, image_idx)
        if fc is not None:
            # ownership handover: read-only, so painters copy first
            fc.put(image_idx, c, img, own=True)
            img.flags.writeable = False
            if copy:
                return np.array(img, copy=True)
        return img

    def base_images(self, image_idx, pool=None):
        """Undistorted base images for one frame: {camera: [H, W, 3] uint8},
        decoded once and shared by every source's composite."""

        def one(camera):
            return camera, self.undistorted_image(camera, image_idx, copy=False)

        cams = self.scene.camera_list
        results = pool.map(one, cams) if pool is not None else map(one, cams)
        return dict(results)

    def _composite_base(self, camera, image_idx, base, out):
        """Base pixels for painting: into the persistent `out` buffer when
        given, else a private copy."""
        src = base[camera] if base is not None else self.undistorted_image(
            camera, image_idx, copy=False)
        if out is not None:
            buf = out[camera]
            np.copyto(buf, src)
            return buf
        return np.array(src, copy=True) if base is not None or not src.flags.writeable else src

    def composite_out_buffers(self):
        """{camera: [H, W, 3] uint8} persistent composite buffers."""
        h, w = self.scene.output_size
        return {c: np.empty((h, w, 3), np.uint8) for c in self.scene.camera_list}

    def composite_frame(self, source, image_idx, cls_raster, pool=None,
                        base=None, out=None):
        """cls_raster [C, H, W] uint8 -> {camera: overlay image} (host).
        Pass `base` (from base_images) to reuse decoded frames and `out`
        (composite_out_buffers) to reuse output buffers."""
        table = self._color_tables[source]
        use_native = _native.available()

        def one(c_camera):
            c, camera = c_camera
            r = cls_raster[c]
            if use_native:
                src = base[camera] if base is not None else \
                    self.undistorted_image(camera, image_idx, copy=False)
                buf = out[camera] if out is not None else np.empty_like(src)
                return camera, _native.composite(src, r, table, buf)
            img = self._composite_base(camera, image_idx, base, out)
            nz = np.flatnonzero(r)
            if len(nz):
                img.reshape(-1, 3)[nz] = table[(r.reshape(-1)[nz] - 1) % MAX_CLS]
            return camera, img

        items = list(enumerate(self.scene.camera_list))
        results = pool.map(one, items) if pool is not None else map(one, items)
        return dict(results)

    def composite_frame_sparse(self, source, image_idx, vals, counts,
                               pool=None, base=None, out=None):
        """Sparse lists (vals [C, k], counts [C]) -> {camera: overlay
        image} (host): each camera's list painted in order onto its base
        pixels, by the native compositor or paint_sparse_host."""
        table = self._color_tables[source]
        w = self.scene.output_size[1]
        use_native = _native.available()

        def one(c_camera):
            c, camera = c_camera
            img = self._composite_base(camera, image_idx, base, out)
            if use_native:
                _native.paint_sparse(vals[c], counts[c], table, w, img)
            else:
                paint_sparse_host(img, vals[c], counts[c], table, w)
            return camera, img

        items = list(enumerate(self.scene.camera_list))
        results = pool.map(one, items) if pool is not None else map(one, items)
        return dict(results)

    def _grid_positions(self):
        """{camera: (row, col)} in the reference 3x2 mosaic, or None when the
        scene's cameras don't exactly fill it."""
        if not hasattr(self, "_grid_pos"):
            pos = {cam: (r, c) for r, row in enumerate(CAMERA_GRID)
                   for c, cam in enumerate(row)}
            cams = self.scene.camera_list
            self._grid_pos = pos if set(cams) == set(pos) else None
        return self._grid_pos

    def composite_mosaic_frame(self, source, image_idx, payload, kind, base,
                               mosaic, pool=None):
        """Native fused composite of one frame straight into the 3x2 video
        mosaic: each camera's base pixels and overlay colors are written to
        its slot.

        kind 'raster': payload [C, H, W] uint8 class rasters, or the 2-bit
        packed [C, H, ceil(W/4)] format (detected by width; the unpack is
        fused into the paint).  kind 'sparse': payload (vals [C, k],
        counts [C]) from iter_sparse_points; the base is copied into the
        slot, then each list is painted in order.

        Returns True, or False when the native compositor or the exact
        camera grid is unavailable (callers use composite_frame then)."""
        if not _native.available() or self._grid_positions() is None:
            return False
        pos = self._grid_positions()
        h, w = self.scene.output_size
        table = self._color_tables[source]

        def one(c_camera):
            c, camera = c_camera
            gr, gc = pos[camera]
            slot = mosaic[gr * h:(gr + 1) * h, gc * w:(gc + 1) * w]
            src = base[camera] if base is not None else \
                self.undistorted_image(camera, image_idx, copy=False)
            if kind == "sparse":
                vals, counts = payload
                np.copyto(slot, src)
                _native.paint_sparse(vals[c], counts[c], table, w, slot)
            elif payload.shape[-1] == w:
                _native.composite(src, payload[c], table, slot)
            else:
                _native.composite_packed2(src, payload[c], table, slot, w)

        items = list(enumerate(self.scene.camera_list))
        if pool is not None:
            list(pool.map(one, items))
        else:
            for it in items:
                one(it)
        return True

    def iter_frames(self, source, n_threads=6, mode="auto"):
        """Yields (image_idx, {camera: overlay image}) per valid frame.

        mode: 'raster' streams dense class rasters; 'sparse' streams the
        compacted point lists and paints them on the host; 'auto' serves
        serving_mode's choice.  A sparse frame whose list overflows its k
        is painted from its dense raster instead (counted as
        'sparse_overflow'), in stream order."""
        k = None
        if mode == "auto":
            mode, k = self.serving_mode(source)
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            if mode == "raster":
                for image_idx, raster in self.iter_overlay_rasters(source):
                    with self.timers.phase("host_composite"):
                        frame = self.composite_frame(source, image_idx,
                                                     raster, pool=pool)
                    yield image_idx, frame
                return
            for image_idx, vals, counts in self.iter_sparse_points(source,
                                                                   k=k):
                if counts.max() > vals.shape[-1]:
                    self.timers.add("sparse_overflow", 0.0)
                    raster = self._overlay_single(source, image_idx)
                    with self.timers.phase("host_composite"):
                        frame = self.composite_frame(source, image_idx,
                                                     raster, pool=pool)
                else:
                    with self.timers.phase("host_composite"):
                        frame = self.composite_frame_sparse(
                            source, image_idx, vals, counts, pool)
                yield image_idx, frame

    def write_video(self, source, output_path, fps=10, preset=None):
        """Single-source overlay video (same engine as write_videos)."""
        return self.write_videos({source: output_path}, fps=fps,
                                 preset=preset)[source]

    def write_videos(self, source_paths, fps=10, n_threads=6, preset=None,
                     on_first_frame=None):
        """Write several sources' overlay videos in ONE pass over the clip:
        each frame's base images are decoded + remapped once and every
        source composites onto them; streams are merged by image index.
        Each source streams in its serving mode: sparse lists (a frame
        whose list overflows falls back to its dense raster) or dense
        rasters.

        Args:
            source_paths: {source: output_video_path}
            on_first_frame: optional callable invoked once, right after the
                first video frame has been handed to its encoder.
        Returns {source: frames_written}.
        """
        sinks, streams, heads = {}, {}, {}
        counts = {src: 0 for src in source_paths}
        h, w = self.scene.output_size
        fused = _native.available() and self._grid_positions() is not None
        try:
            for src, path in source_paths.items():
                mode, k = self.serving_mode(src)
                sinks[src] = VideoSink(path, output_shape=(w * 3, h * 2), fps=fps,
                                       preset=preset)
                streams[src] = (mode, self.iter_overlay_rasters(
                    src, unpack=not fused) if mode == "raster"
                    else self.iter_sparse_points(src, k=k))
            bufs = {src: self.composite_out_buffers() for src in source_paths} \
                if not fused else None
            mosaics = {src: np.empty((h * 2, w * 3, 3), np.uint8)
                       for src in source_paths} if fused else None
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                for src, (_, it) in streams.items():
                    heads[src] = next(it, None)
                while any(head is not None for head in heads.values()):
                    idx = min(head[0] for head in heads.values() if head is not None)
                    with self.timers.phase("host_decode"):
                        base = self.base_images(idx, pool=pool)
                    for src, head in heads.items():
                        if head is None or head[0] != idx:
                            continue
                        kind, it = streams[src]
                        with self.timers.phase("host_composite"):
                            if kind == "raster":
                                payload = head[1]
                            elif head[2].max() > head[1].shape[-1]:
                                self.timers.add("sparse_overflow", 0.0)
                                kind = "raster"
                                payload = self._overlay_single(src, idx)
                            else:
                                payload = head[1:]
                            if fused:
                                self.composite_mosaic_frame(
                                    src, idx, payload, kind, base,
                                    mosaics[src], pool=pool)
                            elif kind == "raster":
                                frame = self.composite_frame(
                                    src, idx, payload, pool=pool, base=base,
                                    out=bufs[src])
                            else:
                                frame = self.composite_frame_sparse(
                                    src, idx, *payload, pool=pool, base=base,
                                    out=bufs[src])
                        if fused:
                            sinks[src].add_frame(mosaics[src])
                        else:
                            sinks[src].add_frame_from_dict(frame)
                        counts[src] += 1
                        if on_first_frame is not None:
                            on_first_frame()
                            on_first_frame = None
                        heads[src] = next(it, None)
        finally:
            _close_all_sinks(sinks)
        return counts


class MultiScenePipeline:
    """Several scenes' dense overlay rasters, served together: one chunk of
    frames of every member scene is dispatched at once.

    Counterpart of cama_tpu/pipeline.py's MultiScenePipeline, without its
    adaptive warm-up lane.  Per chunk, each member scene runs its lane's
    list program (for 'fused', one fused_compact_project per scene, at the
    largest union cap of the members); the lists are stacked [S, chunk, ...]
    and the raster and packing stages run once over all of them.  Members
    share one raster_kernel lane, device and output size; frames past a
    shorter member's end carry frame_valid False.  The rasters equal each
    member's own ClipPipeline rasters (the 'compact' lane serves single
    stage here, which gives the same rasters)."""

    def __init__(self, pipelines, source="cama", chunk=8):
        self.pipelines = list(pipelines)
        if not self.pipelines:
            raise ValueError("need at least one pipeline")
        self.source = source
        self.chunk = int(chunk)
        self._stacked_cache = {}
        for attr in ("raster_kernel", "device"):
            values = {getattr(p, attr) for p in self.pipelines}
            if len(values) != 1:
                raise ValueError(f"scenes disagree on {attr}: {values}")
        sizes = {p.scene.output_size for p in self.pipelines}
        if len(sizes) != 1:
            raise ValueError(f"scenes disagree on output size: {sizes}")
        self.raster_kernel = self.pipelines[0].raster_kernel
        self.device = self.pipelines[0].device
        self.timers = PhaseTimers()

    def members(self, source):
        """Indices of member pipelines that carry this label source."""
        return [i for i, p in enumerate(self.pipelines)
                if source in p.scene.flat]

    def _stacked(self, source=None):
        """(frame matrices, real frame counts, A [S, Fp, 4, 4],
        B [S, Fp, C, 3, 4], frame_valid [S, Fp]) of the members carrying
        `source`, on the device, padded to Fp, the largest padded frame
        count rounded up to the chunk (pad frames: identity A, zero B,
        frame_valid False)."""
        source = self.source if source is None else source
        if source not in self._stacked_cache:
            pipes = [self.pipelines[i] for i in self.members(source)]
            if not pipes:
                raise ValueError(f"no member scene carries source {source!r}")
            mats = [p._chunked_AB(source) for p in pipes]
            Fp = max(len(m[3]) for m in mats)
            Fp = -(-Fp // self.chunk) * self.chunk
            A = np.tile(np.eye(4, dtype=np.float32), (len(mats), Fp, 1, 1))
            B = np.zeros((len(mats), Fp) + mats[0][2].shape[1:], np.float32)
            fv = np.zeros((len(mats), Fp), bool)
            for i, (_, Ai, Bi, fvi, _) in enumerate(mats):
                A[i, :len(fvi)], B[i, :len(fvi)], fv[i, :len(fvi)] = Ai, Bi, fvi
            tensors = (torch.from_numpy(a).to(self.device) for a in (A, B, fv))
            self._stacked_cache[source] = ([m[0] for m in mats],
                                           [m[4] for m in mats], *tensors)
        return self._stacked_cache[source]

    def _source_state(self, source):
        """Per-source serving state: member indices, frame maps, the stacked
        frame matrices, the link packing, the shared list size k (the
        largest of the members' own dense list sizes, from their counting
        passes) and each member's limit for its counts: k, or its own P
        for 'scatter', which has no list."""
        members = self.members(source)
        fms, Fs, A, B, fv = self._stacked(source)
        pipes = [self.pipelines[i] for i in members]
        for p in pipes:
            p.overlay_mode(source)
        sizes = [p._k[source] for p in pipes]
        return {"members": members, "pipes": pipes, "fms": fms, "Fs": Fs,
                "A": A, "B": B, "fv": fv, "k": max(sizes),
                "limits": (sizes if self.raster_kernel == "scatter"
                           else [max(sizes)] * len(sizes)),
                "use_2bit": all(p._use_2bit(source) for p in pipes),
                "source": source}

    def _dispatch_chunk(self, state, s):
        """Queue one chunk of every member scene of a source: (rasters
        [S, chunk, C, H, W(/4)], counts [S, chunk]) on their way to pinned
        host buffers, and the event marking their arrival; None past the
        end."""
        A, B, fv = state["A"], state["B"], state["fv"]
        if s >= fv.shape[1]:
            return None
        h, w = self.pipelines[0].scene.output_size
        lo, hi = self.pipelines[0]._crop_lo, self.pipelines[0]._crop_hi
        lane, two_bit = self.raster_kernel, state["use_2bit"]
        sl = slice(s, s + self.chunk)
        with self.timers.phase("device_dispatch"):
            outs = []
            for i, p in enumerate(state["pipes"]):
                st = p.scene_tensors(state["source"])
                args = (st.points, st.valid, st.cls, A[i, sl], B[i, sl],
                        fv[i, sl], lo, hi, w, h)
                outs.append(_overlay_chunk(*args, two_bit) if lane == "scatter"
                            else _chunk_lists(lane, *args, state["k"]))
            first, count = (torch.stack(t) for t in zip(*outs))
            rasters = first if lane == "scatter" else _lists_to_rasters(
                lane, first, count, w, h, two_bit)
            return _fetch_async((rasters, count), self.device.type == "cuda")

    def _drain_chunk(self, state, s, entry, unpack=True):
        """[(scene index, image_idx, cls_raster [C, H, W] uint8), ...] of a
        dispatched chunk; every member's list counts are checked against
        the list size (an overflow raises).  unpack=False passes the 2-bit
        packed format through (the native mosaic compositor decodes it
        during the paint)."""
        (rasters, count), done = entry
        w = self.pipelines[0].scene.output_size[1]
        with self.timers.phase("raster_fetch"):
            if done is not None:
                done.synchronize()
            count = count.numpy()
            for mi, limit in enumerate(state["limits"]):
                _check_lists(f"scene {state['members'][mi]} "
                             f"{state['source']}", self.raster_kernel, s,
                             count[mi], limit)
            rasters = rasters.numpy()
            if unpack and rasters.shape[-1] != w:
                rasters = unpack_cls_2bit(rasters, w)
        out = []
        for mi, (fm, F) in enumerate(zip(state["fms"], state["Fs"])):
            for j in range(rasters.shape[1]):
                if s + j < F and fm.frame_valid[s + j]:
                    out.append((state["members"][mi],
                                int(fm.frame_indices[s + j]), rasters[mi, j]))
        return out

    def iter_overlay_rasters(self, max_in_flight=3, source=None):
        """Yields (scene_idx, image_idx, cls_raster [C, H, W] uint8) across
        every member scene, chunk by chunk.  At most `max_in_flight`
        chunks' [S, chunk, C, H, W] buffers are pending at once."""
        state = self._source_state(self.source if source is None else source)
        pending = []
        for s in range(0, state["fv"].shape[1], self.chunk):
            pending.append((s, self._dispatch_chunk(state, s)))
            if len(pending) >= max_in_flight:
                yield from self._drain_chunk(state, *pending.pop(0))
        for s, entry in pending:
            yield from self._drain_chunk(state, s, entry)

    def iter_frame_groups(self, sources, max_in_flight=3, unpack=True):
        """Yields, in chunk order, (scene_idx, image_idx, {source:
        cls_raster}), with every source's chunk of every scene dispatched
        back to back."""
        states = {src: self._source_state(src) for src in sources}
        n_chunks = max(-(-st["fv"].shape[1] // self.chunk)
                       for st in states.values())
        pending = []

        def drain(entry):
            s, per_src = entry
            grouped = {}
            for src, chunk in per_src.items():
                if chunk is None:
                    continue
                for si, idx, raster in self._drain_chunk(states[src], s,
                                                         chunk, unpack):
                    grouped.setdefault((si, idx), {})[src] = raster
            for (si, idx), by_src in sorted(grouped.items()):
                yield si, idx, by_src

        for ci in range(n_chunks):
            s = ci * self.chunk
            pending.append((s, {src: self._dispatch_chunk(states[src], s)
                                for src in sources}))
            if len(pending) >= max_in_flight:
                yield from drain(pending.pop(0))
        for entry in pending:
            yield from drain(entry)

    def write_videos(self, per_scene_paths, fps=10, n_threads=6, preset=None,
                     on_first_frame=None):
        """The scene-batched counterpart of ClipPipeline.write_videos:
        every scene's every source's overlay video in one pass, each
        frame's base images decoded once and shared across sources.

        Args:
            per_scene_paths: list (parallel to self.pipelines) of
                {source: output_video_path}
            on_first_frame: optional callable invoked once after the first
                frame of any sink reaches its encoder
        Returns a list of {source: frames_written} per scene.
        """
        sources = sorted({s for paths in per_scene_paths for s in paths})
        h, w = self.pipelines[0].scene.output_size
        counts = [{src: 0 for src in paths} for paths in per_scene_paths]
        sinks = {}
        try:
            for si, paths in enumerate(per_scene_paths):
                for src, path in paths.items():
                    sinks[(si, src)] = VideoSink(
                        path, output_shape=(w * 3, h * 2), fps=fps, preset=preset)
            bufs = {}  # (si, src) -> persistent composite or mosaic buffers
            # the native mosaic path for every scene, or the dict path for
            # every scene: packed 2-bit rasters stream through to the paint
            fused = _native.available() and all(
                p._grid_positions() is not None for p in self.pipelines)
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                for si, idx, by_src in self.iter_frame_groups(
                        sources, unpack=not fused):
                    pipe = self.pipelines[si]
                    with self.timers.phase("host_decode"):
                        base = pipe.base_images(idx, pool=pool)
                    for src, raster in by_src.items():
                        if (si, src) not in sinks:
                            continue
                        with self.timers.phase("host_composite"):
                            if fused:
                                mos = bufs.get((si, src))
                                if mos is None:
                                    mos = bufs[(si, src)] = np.empty(
                                        (h * 2, w * 3, 3), np.uint8)
                                pipe.composite_mosaic_frame(
                                    src, idx, raster, "raster", base, mos,
                                    pool=pool)
                            else:
                                if (si, src) not in bufs:
                                    bufs[(si, src)] = pipe.composite_out_buffers()
                                frame = pipe.composite_frame(
                                    src, idx, raster, pool=pool, base=base,
                                    out=bufs[(si, src)])
                        if fused:
                            sinks[(si, src)].add_frame(mos)
                        else:
                            sinks[(si, src)].add_frame_from_dict(frame)
                        counts[si][src] += 1
                        if on_first_frame is not None:
                            on_first_frame()
                            on_first_frame = None
        finally:
            _close_all_sinks(sinks)
        return counts
