"""Per-clip orchestration on PyTorch: overlay videos from a compiled scene.

Counterpart of cama_tpu/pipeline.py's single-scene dense path.  Per chunk of
frames, one device program of the pipeline's raster_kernel lane turns the
scene's points into class rasters:

  'fused'    the fused CUDA kernel (project + crop + dedup + stable
             compaction, ops/fused_compact.py) -> union list
  'pallas'   the CUDA projection kernel (ops/pallas_project.py), then the
             per-camera dedup + stable compaction (ops/raster.py)
  'compact'  the same program with the plain projection (ops/geometry.py)
  'scatter'  the plain projection, every kept point scattered, no list

then a scatter-max at the list's centres and two plus-stencil dilations
(ops/raster.py), and ships uint8 class rasters (2-bit packed when the
classes fit) to the host, where base images are undistorted once per frame
and composited into the 3x2 video mosaic.  Every lane keeps the same points
and paints them in the same order, so all four give the same rasters.

The device is explicit: `device='cuda'` runs the kernels and raises without
a card; `device='cpu'` runs the plain PyTorch versions (what the tests do).
Scenes are written one after another; the JAX package's multi-scene batch,
sparse serving mode and adaptive warm-up lane are not part of this package.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

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
    count_union,
    fused_compact_project,
    rasterize_from_union,
)
from cama_tpu_torch.ops.geometry import (
    compose_frame_matrices,
    crop_bounds,
    project_frames,
)
from cama_tpu_torch.ops.pallas_project import project_frame_pallas
from cama_tpu_torch.ops.raster import (
    CIRCLE_R2_OFFSETS,
    MAX_CLS,
    build_color_table,
    compact_points,
    effective_counts,
    pack_cls_2bit,
    packed_to_cls,
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


def _overlay_chunk_fused(points, valid, cls, A, B, frame_valid, crop_lo,
                         crop_hi, width, height, k_cap, two_bit):
    """One chunk of F frames -> (class rasters [F, C, H, W] uint8, or 2-bit
    packed [F, C, H, ceil(W/4)], and the union counts [F] int32)."""
    vals, count = fused_compact_project(points, valid, cls, A, B, frame_valid,
                                        width, height, crop_lo, crop_hi, k_cap)
    rasters = packed_to_cls(rasterize_from_union(vals, count, width, height))
    return (pack_cls_2bit(rasters) if two_bit else rasters), count


def _compact_raster(vu, keep, cls, width, height, k, two_bit):
    """Projection -> per-camera compaction to k entries -> rasters.
    Returns (class rasters, packed when two_bit, and the largest per-camera
    survivor count [F] int32)."""
    vals, counts = compact_points(vu, keep, cls, width, height, k)
    rasters = packed_to_cls(rasterize_from_compact(vals, width, height))
    return (pack_cls_2bit(rasters) if two_bit else rasters), counts.amax(-1)


def _overlay_chunk_pallas(points, valid, cls, A, B, frame_valid, crop_lo,
                          crop_hi, width, height, k, two_bit):
    """The 'pallas' lane: one launch of the CUDA projection kernel for the
    chunk, then compaction and the compact rasterizer.  Returns (rasters,
    counts [F])."""
    vu, keep = project_frame_pallas(points, valid, A, B, frame_valid, width,
                                    height, crop_lo, crop_hi)
    return _compact_raster(vu, keep, cls, width, height, k, two_bit)


def _overlay_chunk_compact(points, valid, cls, A, B, frame_valid, crop_lo,
                           crop_hi, width, height, k, two_bit):
    """The 'compact' lane (single stage): the 'pallas' program with the
    plain projection.  Returns (rasters, counts [F])."""
    vu, keep = project_frames(points, valid, A, B, frame_valid, width, height,
                              crop_lo, crop_hi)
    return _compact_raster(vu, keep, cls, width, height, k, two_bit)


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


_LIST_PROGRAMS = {"fused": _overlay_chunk_fused,
                  "pallas": _overlay_chunk_pallas,
                  "compact": _overlay_chunk_compact}
_LANE_PROJECTIONS = {"pallas": project_frame_pallas,
                     "compact": project_frames}


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
        'compact' is single-stage; the rasters equal the JAX package's
        two-stage form.  device: 'cuda' runs the CUDA kernels and raises
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
        self._k = {}
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
        """('raster', k): the list size of this pipeline's lane, from a
        counting pass over every chunk with the lane's own projection — the
        fused kernel's union count, or the largest per-camera deduped count
        of the 'pallas' kernel or the plain projection — rounded to the
        power of two >= the largest count, at least 1024, at most P.  The
        'scatter' lane has no list: every kept point scatters, so k = P."""
        if source not in self._k:
            st = self.scene_tensors(source)
            P = int(st.points.shape[0])
            h, w = self.scene.output_size
            lane = self.raster_kernel
            if lane == "scatter":
                self._k[source] = P
                return "raster", P
            top = 0
            for s in range(0, st.A.shape[0], self.chunk):
                sl = slice(s, s + self.chunk)
                if lane == "fused":
                    cnt = count_union(st.points, st.valid, st.cls, st.A[sl],
                                      st.B[sl], st.frame_valid[sl], w, h,
                                      self._crop_lo, self._crop_hi)
                else:
                    vu, keep = _LANE_PROJECTIONS[lane](
                        st.points, st.valid, st.A[sl], st.B[sl],
                        st.frame_valid[sl], w, h, self._crop_lo,
                        self._crop_hi)
                    cnt = effective_counts(vu, keep, st.cls, w, h)
                top = max(top, int(cnt.max()))
            self._k[source] = _pow2_cap(top, P)
        return "raster", self._k[source]

    def _use_2bit(self, source):
        fp = self.scene.flat[source]
        max_cls = int(fp.cls[fp.valid].max()) if fp.valid.any() else 0
        return max_cls <= 2  # raster values cls+1 must fit in 2 bits

    def iter_overlay_rasters(self, source, max_in_flight=16, unpack=True):
        """Yield (image_idx, cls_raster [C, H, W] uint8 on host) per valid
        frame.  Chunks are queued on the device ahead of consumption; each
        chunk's rasters and counts are copied into pinned host buffers with
        non_blocking copies, one CUDA event per chunk marks their arrival,
        and at most `max_in_flight` chunks are pending at once.  Every
        frame's list count is checked against the lane's k when its chunk is
        drained (an overflowed list raises).

        unpack=False hands the 2-bit packed [C, H, ceil(W/4)] format
        through untouched (when the scene uses it) — the native mosaic
        compositor decodes it during the paint pass."""
        fm, _, _, _, F = self._chunked_AB(source)
        st = self.scene_tensors(source)
        use_2bit = self._use_2bit(source)
        h, w = self.scene.output_size
        _, k = self.overlay_mode(source)
        lane = self.raster_kernel
        on_card = self.device.type == "cuda"

        def dispatch(sl):
            with self.timers.phase("device_dispatch"):
                args = (st.points, st.valid, st.cls, st.A[sl], st.B[sl],
                        st.frame_valid[sl], self._crop_lo, self._crop_hi, w, h)
                if lane == "scatter":
                    rasters, count = _overlay_chunk(*args, use_2bit)
                else:
                    rasters, count = _LIST_PROGRAMS[lane](*args, k, use_2bit)
                if not on_card:
                    return rasters, count, None
                r_host = torch.empty(rasters.shape, dtype=rasters.dtype,
                                     pin_memory=True)
                c_host = torch.empty(count.shape, dtype=count.dtype,
                                     pin_memory=True)
                r_host.copy_(rasters, non_blocking=True)
                c_host.copy_(count, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                return r_host, c_host, done

        def drain(entry):
            s, (rasters, count, done) = entry
            with self.timers.phase("raster_fetch"):
                if done is not None:
                    done.synchronize()
                count = count.numpy()
                if (count > k).any():
                    f = int(np.argmax(count))
                    raise RuntimeError(
                        f"{source}: frame {s + f} keeps {int(count[f])} list "
                        f"rows, over the {lane} list size k={k}")
                rasters = rasters.numpy()
                if unpack and rasters.shape[-1] != w:
                    rasters = unpack_cls_2bit(rasters, w)  # [chunk, C, H, W]
            out = []
            for j in range(rasters.shape[0]):
                fidx = s + j
                if fidx >= F or not fm.frame_valid[fidx]:
                    continue
                out.append((int(fm.frame_indices[fidx]), rasters[j]))
            return out

        pending = []
        for s in range(0, st.A.shape[0], self.chunk):
            pending.append((s, dispatch(slice(s, s + self.chunk))))
            if len(pending) >= max_in_flight:
                yield from drain(pending.pop(0))
        for entry in pending:
            yield from drain(entry)

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

    def _grid_positions(self):
        """{camera: (row, col)} in the reference 3x2 mosaic, or None when the
        scene's cameras don't exactly fill it."""
        if not hasattr(self, "_grid_pos"):
            pos = {cam: (r, c) for r, row in enumerate(CAMERA_GRID)
                   for c, cam in enumerate(row)}
            cams = self.scene.camera_list
            self._grid_pos = pos if set(cams) == set(pos) else None
        return self._grid_pos

    def composite_mosaic_frame(self, source, image_idx, payload, base, mosaic,
                               pool=None):
        """Native fused composite of one frame straight into the 3x2 video
        mosaic: each camera's base pixels and overlay colors are written to
        its slot in one streaming pass.  payload: [C, H, W] uint8 class
        rasters or the 2-bit packed [C, H, ceil(W/4)] format.

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
            if payload.shape[-1] == w:
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

    def write_video(self, source, output_path, fps=10, preset=None):
        """Single-source overlay video (same engine as write_videos)."""
        return self.write_videos({source: output_path}, fps=fps,
                                 preset=preset)[source]

    def write_videos(self, source_paths, fps=10, n_threads=6, preset=None,
                     on_first_frame=None):
        """Write several sources' overlay videos in ONE pass over the clip:
        each frame's base images are decoded + remapped once and every
        source composites onto them; streams are merged by image index.

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
                sinks[src] = VideoSink(path, output_shape=(w * 3, h * 2), fps=fps,
                                       preset=preset)
                streams[src] = self.iter_overlay_rasters(src, unpack=not fused)
            bufs = {src: self.composite_out_buffers() for src in source_paths} \
                if not fused else None
            mosaics = {src: np.empty((h * 2, w * 3, 3), np.uint8)
                       for src in source_paths} if fused else None
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                for src, it in streams.items():
                    heads[src] = next(it, None)
                while any(head is not None for head in heads.values()):
                    idx = min(head[0] for head in heads.values() if head is not None)
                    with self.timers.phase("host_decode"):
                        base = self.base_images(idx, pool=pool)
                    for src, head in heads.items():
                        if head is None or head[0] != idx:
                            continue
                        with self.timers.phase("host_composite"):
                            if fused:
                                self.composite_mosaic_frame(
                                    src, idx, head[1], base, mosaics[src],
                                    pool=pool)
                            else:
                                frame = self.composite_frame(
                                    src, idx, head[1], pool=pool, base=base,
                                    out=bufs[src])
                        if fused:
                            sinks[src].add_frame(mosaics[src])
                        else:
                            sinks[src].add_frame_from_dict(frame)
                        counts[src] += 1
                        if on_first_frame is not None:
                            on_first_frame()
                            on_first_frame = None
                        heads[src] = next(streams[src], None)
        finally:
            _close_all_sinks(sinks)
        return counts
