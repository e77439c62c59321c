"""Multi-device overlay and metric steps over a mesh of torch.distributed
ranks.

Counterpart of cama_tpu/parallel/sharding.py.  The JAX package runs these
steps single-controller: one process holds every device, and shard_map
cuts global arrays by PartitionSpecs.  PyTorch runs one process per rank,
so the port is SPMD: every rank calls the same step with the same global
host arrays (the JAX step's inputs), takes its own shard by its
coordinates on the mesh, uploads only that shard to its device, and meets
the other ranks in collectives that stand where JAX's stand:

  * jax.lax.pmax(packed, 'points') -> all_reduce(MAX) over the points
    group.  Exact: a packed raster holds paint priorities, and the shards
    are contiguous point slices, so the elementwise maximum over the
    shards is the global last-drawn-wins;
  * jax.lax.psum(..., 'frames') -> all_reduce(SUM) over the frames group;
  * jax.lax.axis_index('points') -> the rank's coordinate on that axis.

Data parallelism over frames (and over scenes for the batched steps), and
the point axis split as a sequence-parallel analogue, as in the JAX
package.  A compacting kernel's list counts meet in one all_reduce(MAX)
over the whole mesh before any rank acts on them: a list of a given size
that overflows on any rank raises on every rank (a rank that raised alone
would leave the others waiting in their next collective), and a list
whose size is left to the step is sized to fit on every rank alike.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from cama_tpu_torch.eval.map_metrics import PARTIAL_KEYS, frame_metrics_rows
from cama_tpu_torch.ops.fused_compact import (count_union,
                                              fused_compact_project,
                                              rasterize_from_union)
from cama_tpu_torch.ops.geometry import (crop_compact_project,
                                         crop_compact_project_idx,
                                         project_frames)
from cama_tpu_torch.ops.raster import (MAX_CLS, compact_points,
                                       effective_counts, packed_to_cls,
                                       rasterize_from_compact,
                                       rasterize_packed_fast)
from cama_tpu_torch.pipeline import _pow2_cap, resolve_device

OVERLAY_KERNELS = ("fast", "compact", "two_stage", "fused")
_INT32_MAX = 2 ** 31 - 1
_MAX, _SUM = dist.ReduceOp.MAX, dist.ReduceOp.SUM


def _world():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device="cuda"):
    """This rank's torch.device: 'cuda' is cuda:LOCAL_RANK (0 when the
    launcher set none), 'cuda:N' that card, 'cpu' the CPU.  A card asked
    for where there is none raises (pipeline.resolve_device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


class Mesh:
    """A named mesh of torch.distributed ranks, one device each: the port's
    jax.sharding.Mesh.  `shape` maps each axis name to its size in axis
    order (mesh.shape['frames'] as in JAX); ranks lie on the mesh
    row-major, as init_device_mesh lays them, and the mesh spans the whole
    world.  A mesh of one rank needs no process group: its collectives are
    identities.  Collectives run on each axis's group from
    init_device_mesh, with the backend the process group was started with
    (multihost.initialize)."""

    def __init__(self, axis_names, sizes, device="cuda"):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device = rank_device(device)
        n = math.prod(self.shape.values())
        world = _world()
        if n != world:
            raise ValueError(
                f"a mesh of {n} ranks {self.shape} over a world of {world}: "
                "start one process per rank (multihost.initialize)")
        self._mesh = None
        self.ranks = (0,)
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._mesh = init_device_mesh(
                self.device.type, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)
            self.ranks = tuple(self._mesh.mesh.flatten().tolist())

    def coord(self, axis):
        """This rank's index along `axis`."""
        return 0 if self._mesh is None else self._mesh.get_local_rank(axis)

    def group(self, axis):
        """The process group of this rank's line along `axis`."""
        return None if self._mesh is None else self._mesh.get_group(axis)

    def all_reduce(self, t, op, axes=None):
        """Reduce `t` in place over the groups of `axes` (default: every
        axis, i.e. the whole mesh) in turn; axes of one rank are skipped.
        Returns t."""
        for axis in self.axis_names if axes is None else axes:
            if self.shape[axis] > 1:
                dist.all_reduce(t, op=op, group=self.group(axis))
        return t

    def gather(self, t, axis):
        """Every shard of `axis` concatenated along dim 0, on every rank of
        the line (the global array over that axis from each rank's
        shard)."""
        n = self.shape[axis]
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self.group(axis))
        return torch.cat(parts)


def make_mesh(n_frames_axis=None, n_points_axis=1, device="cuda"):
    """A ('frames', 'points') mesh over every rank; by default every rank
    on the frames axis."""
    if n_frames_axis is None:
        n_frames_axis = _world() // n_points_axis
    return Mesh(("frames", "points"), (n_frames_axis, n_points_axis), device)


def make_scene_mesh(n_scenes_axis=None, n_frames_axis=1, device="cuda"):
    """A ('scenes', 'frames') mesh over every rank: data parallelism over
    the scene batch, with optional frame-axis data parallelism inside each
    scene shard.  By default every rank on the scenes axis."""
    if n_scenes_axis is None:
        n_scenes_axis = _world() // n_frames_axis
    return Mesh(("scenes", "frames"), (n_scenes_axis, n_frames_axis), device)


def pad_to_multiple(arr, multiple, axis=0, fill=0):
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


class LocalBlock:
    """A step argument that already holds this rank's block under the
    step's spec for it, rather than the global array: a caller that loads
    only its own shard (the sharded fleet evaluation's ground truth) passes
    it wrapped in this, and the step uploads it as it is."""

    def __init__(self, block):
        self.block = block


def _shard(mesh, a, spec, dtype):
    """This rank's block of the global host array `a` (NumPy or a CPU
    tensor) under `spec`, one mesh axis name or None per leading dim, as
    `dtype` on the rank's device.  A LocalBlock is that block already."""
    if isinstance(a, LocalBlock):
        t = torch.as_tensor(np.asarray(a.block))
        return t.to(device=mesh.device, dtype=dtype).contiguous()
    t = torch.as_tensor(np.asarray(a))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"divide by mesh axis {axis!r} ({n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.coord(axis) * size, size)
    return t.to(device=mesh.device, dtype=dtype).contiguous()


def mesh_max(mesh, *counts):
    """The largest entry of each count tensor over the whole mesh: one
    all_reduce(MAX) of the local maxima.  Returns Python ints."""
    local = torch.stack([c.max().to(torch.int64) if c.numel()
                         else torch.zeros((), dtype=torch.int64,
                                          device=c.device)
                         for c in counts]).to(mesh.device)
    return mesh.all_reduce(local, _MAX).tolist()


def _check_list(n, size, what):
    """Raise (on every rank, since n came from mesh_max) when a list of
    `size` entries would need n."""
    if n > size:
        raise RuntimeError(
            f"{what}: a rank's list needs {n} entries, over its size {size}; "
            "every rank of the mesh raises")


def _check_headroom(n_shards, size):
    """Packed priorities (shard * size + index) * MAX_CLS + cls must fit
    in int32."""
    if n_shards * size * MAX_CLS > _INT32_MAX:
        raise ValueError(
            f"{n_shards} point shards of {size} list entries overflow the "
            f"int32 paint priorities ({n_shards * size * MAX_CLS} > "
            f"{_INT32_MAX})")


def _painted_per_class(rasters):
    """[MAX_CLS] int32 painted-pixel counts of class rasters (0 =
    unpainted, else class + 1)."""
    return torch.stack([(rasters == c + 1).sum(dtype=torch.int32)
                        for c in range(MAX_CLS)])


def sharded_overlay_step(mesh, width, height, kernel="fast", k=None,
                         k1=None):
    """Build the multi-device overlay step over a ('frames', 'points') mesh:

        (points [P, 3], valid [P], cls [P], A [F, 4, 4], B [F, C, 3, 4],
         frame_valid [F], crop_lo, crop_hi)   -- global host arrays
          -> (class rasters [F / f, C, H, W] uint8: this rank's frame shard
              on its device, painted_per_class [MAX_CLS] int32 summed over
              every frame, the same on every rank)

    F must divide by mesh.shape['frames'], P by mesh.shape['points'];
    mesh.gather(rasters, 'frames') puts the whole [F, C, H, W] together on
    every rank.

    kernel: 'fast' (scatter-max at the centres + dilation, no compaction),
    'compact' (projection, then per-camera dedup + stable compaction to `k`
    entries), 'two_stage' (crop-first compaction to `k1` survivors per
    shard before the per-camera compactions) or 'fused' (the fused CUDA
    kernel, ops.fused_compact.fused_compact_project, over the rank's
    frames in one launch, with a union list of `k` rows).  Cross-shard
    paint order stays global in all four: 'fast' offsets priorities by the
    shard's first point index, the compacting kernels by shard_index * k.
    A shard-boundary duplicate that single-device dedup would drop paints
    the same pixels as its successor, whose priority is higher, so the
    class rasters equal the single-device paths' byte for byte.

    k: the list size of the compacting kernels.  None sizes it for each
    call from this call's counts (count_union for 'fused', the effective
    per-camera counts otherwise), the same size on every rank.  A given k
    that a rank's list overflows raises on every rank (the JAX step clamps
    silently).  k1 (required by 'two_stage') is held the same way."""
    if kernel not in OVERLAY_KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "two_stage" and k1 is None:
        raise ValueError("two_stage needs k1 (per-shard crop-survivor budget)")
    n_shards = mesh.shape["points"]
    if k is not None:
        _check_headroom(n_shards, k)

    def step(points, valid, cls, A, B, frame_valid, crop_lo, crop_hi):
        pts = _shard(mesh, points, ("points", None), torch.float32)
        ok = _shard(mesh, valid, ("points",), torch.bool)
        cl = _shard(mesh, cls, ("points",), torch.int32)
        A_l = _shard(mesh, A, ("frames",), torch.float32)
        B_l = _shard(mesh, B, ("frames",), torch.float32)
        fv = _shard(mesh, frame_valid, ("frames",), torch.bool)
        geo = (width, height, crop_lo, crop_hi)
        shard, P_l = mesh.coord("points"), pts.shape[0]
        if kernel == "fast":
            _check_headroom(n_shards, P_l)
            vu, keep = project_frames(pts, ok, A_l, B_l, fv, *geo)
            packed = rasterize_packed_fast(vu, keep, cl, width, height,
                                           prio_offset=shard * P_l)
        elif kernel == "fused":
            size = k
            if size is None:
                (n,) = mesh_max(mesh, count_union(pts, ok, cl, A_l, B_l,
                                                   fv, *geo))
                size = _pow2_cap(n, P_l)
                _check_headroom(n_shards, size)
            vals, count = fused_compact_project(pts, ok, cl, A_l, B_l, fv,
                                                *geo, size)
            if k is not None:
                _check_list(*mesh_max(mesh, count), k, "fused union list")
            packed = rasterize_from_union(vals, count, width, height,
                                          prio_offset=shard * size)
        else:
            if kernel == "two_stage":
                vu, keep, cls_sel, n_crop = crop_compact_project(
                    pts, ok, cl, A_l, B_l, fv, *geo, k1)
                cl_l = cls_sel[:, None, :]
                firsts = (n_crop,)
            else:
                vu, keep = project_frames(pts, ok, A_l, B_l, fv, *geo)
                cl_l, firsts = cl, ()
            cap = k1 if kernel == "two_stage" else P_l
            if k is None:
                *m, n = mesh_max(mesh, *firsts, effective_counts(
                    vu, keep, cl_l, width, height))
                size = _pow2_cap(n, cap)
                _check_headroom(n_shards, size)
                vals, _ = compact_points(vu, keep, cl_l, width, height, size)
            else:
                size = k
                vals, counts = compact_points(vu, keep, cl_l, width, height,
                                              k)
                *m, n = mesh_max(mesh, *firsts, counts)
                _check_list(n, k, f"{kernel} list")
            if firsts:
                _check_list(m[0], k1, "two_stage crop list")
            packed = rasterize_from_compact(vals, width, height,
                                            prio_offset=shard * size)
        packed = mesh.all_reduce(packed, _MAX, ("points",))
        rasters = packed_to_cls(packed)
        counts = mesh.all_reduce(_painted_per_class(rasters), _SUM,
                                 ("frames",))
        return rasters, counts

    return step


def sharded_multi_scene_step(mesh, width, height, k, two_bit=False):
    """The multi-device scene-batched overlay step over a ('scenes',
    'frames') mesh, the sharded form of the single-device batched program:

        (points [S, P, 3], valid [S, P], cls [S, P], A [S, F, 4, 4],
         B [S, F, C, 3, 4], frame_valid [S, F], crop_lo, crop_hi)
          -> class rasters [S / s, F / f, C, H, W] uint8 (2-bit packed
             when two_bit): this rank's scenes and frames

    Each rank runs pipeline._overlay_chunk_compact (the single-device
    'compact' program) on each of its scenes' full point sets, so no
    cross-rank combine is needed: the rasters equal the single-device
    batched rasters.  S must divide by mesh.shape['scenes'], F by
    mesh.shape['frames'].  A list over k entries on any rank raises on
    every rank."""
    from cama_tpu_torch.pipeline import _overlay_chunk_compact

    def step(points, valid, cls, A, B, frame_valid, crop_lo, crop_hi):
        pts = _shard(mesh, points, ("scenes", None, None), torch.float32)
        ok = _shard(mesh, valid, ("scenes", None), torch.bool)
        cl = _shard(mesh, cls, ("scenes", None), torch.int32)
        A_l = _shard(mesh, A, ("scenes", "frames"), torch.float32)
        B_l = _shard(mesh, B, ("scenes", "frames"), torch.float32)
        fv = _shard(mesh, frame_valid, ("scenes", "frames"), torch.bool)
        outs = [_overlay_chunk_compact(pts[s], ok[s], cl[s], A_l[s], B_l[s],
                                       fv[s], crop_lo, crop_hi, width,
                                       height, k, two_bit)
                for s in range(pts.shape[0])]
        _check_list(max(mesh_max(mesh, *(c for _, c in outs))), k,
                    "compact list")
        return torch.stack([r for r, _ in outs])

    return step


def _metric_projection(points, valid, A, B, fv, width, height, crop_lo,
                       crop_hi, k1):
    """The projection of a sharded metric step over a chunk of frames:
    full-P, or crop-compacted to k1 survivors when sized (the evaluator's
    two-stage; keep requires the crop box, so the metric sums are
    unchanged).  Returns (vu, keep, the crop counts [F] or None)."""
    if k1 is not None:
        vu, keep, _, n_crop = crop_compact_project_idx(
            points, valid, A, B, fv, width, height, crop_lo, crop_hi, k1)
        return vu, keep, n_crop
    vu, keep = project_frames(points, valid, A, B, fv, width, height,
                              crop_lo, crop_hi)
    return vu, keep, None


def _frame_partials(gt, vu, keep, fv, max_radius, tolerance, distance):
    """[5] float64 partial sums (PARTIAL_KEYS order) over a chunk's rows
    whose frame_valid is set."""
    rows = frame_metrics_rows(gt, vu, keep, max_radius, tolerance, distance)
    z = fv.to(torch.float64)
    return torch.stack([(rows[k2].to(torch.float64) * z).sum()
                        for k2 in PARTIAL_KEYS])


def sharded_scene_batch_metrics(mesh, width, height, max_radius, tolerance,
                                distance="chebyshev", k1=None):
    """The sharded fleet evaluation step over a ('scenes', 'frames') mesh:
    scenes shard over 'scenes', each scene's frame rows over 'frames';
    per-scene partial sums reduce over the frames axis only (a sum over
    'scenes' would merge unrelated scenes' metrics).

        (points [S, P, 3], valid [S, P], gt [S, F, C, H, W] bool,
         A [S, F, 4, 4], B [S, F, C, 3, 4], frame_valid [S, F], crop_lo,
         crop_hi)
          -> {metric: [S / s] float64}: this rank's scenes' partial sums,
             the same on every rank of its frames line

    gt and frame_valid may each come as a LocalBlock holding only this
    rank's [S / s, F / f] block.  Rows whose frame_valid is False (no
    ground truth) add nothing.  A crop list over k1 on any rank raises on
    every rank."""

    def step(points, valid, gt, A, B, frame_valid, crop_lo, crop_hi):
        pts = _shard(mesh, points, ("scenes", None, None), torch.float32)
        ok = _shard(mesh, valid, ("scenes", None), torch.bool)
        gt_l = _shard(mesh, gt, ("scenes", "frames"), torch.bool)
        A_l = _shard(mesh, A, ("scenes", "frames"), torch.float32)
        B_l = _shard(mesh, B, ("scenes", "frames"), torch.float32)
        fv = _shard(mesh, frame_valid, ("scenes", "frames"), torch.bool)
        sums, crops = [], []
        for s in range(pts.shape[0]):
            vu, keep, n_crop = _metric_projection(
                pts[s], ok[s], A_l[s], B_l[s], fv[s], width, height,
                crop_lo, crop_hi, k1)
            sums.append(_frame_partials(gt_l[s], vu, keep, fv[s],
                                        max_radius, tolerance, distance))
            crops.append(n_crop)
        if k1 is not None:
            _check_list(max(mesh_max(mesh, *crops)), k1, "metric crop list")
        out = mesh.all_reduce(torch.stack(sums, dim=1), _SUM, ("frames",))
        return dict(zip(PARTIAL_KEYS, out))

    return step


def sharded_map_metrics(mesh, width, height, max_radius, tolerance,
                        distance="chebyshev", k1=None):
    """Multi-device SRE / precision / recall partials over a mesh with a
    'frames' axis: the ground-truth masks and frame matrices shard over
    'frames', the points are whole on every rank, and the partial sums
    reduce over 'frames' into totals that every rank holds.

        (points [P, 3], valid [P], gt [F, C, H, W] bool, A [F, 4, 4],
         B [F, C, 3, 4], frame_valid [F], crop_lo, crop_hi)
          -> {metric: 0-d float64} (sre_sum, n_points, n_hit, gt_total,
             gt_covered)

    A crop list over k1 on any rank raises on every rank."""

    def step(points, valid, gt, A, B, frame_valid, crop_lo, crop_hi):
        pts = _shard(mesh, points, (), torch.float32)
        ok = _shard(mesh, valid, (), torch.bool)
        gt_l = _shard(mesh, gt, ("frames",), torch.bool)
        A_l = _shard(mesh, A, ("frames",), torch.float32)
        B_l = _shard(mesh, B, ("frames",), torch.float32)
        fv = _shard(mesh, frame_valid, ("frames",), torch.bool)
        vu, keep, n_crop = _metric_projection(pts, ok, A_l, B_l, fv, width,
                                              height, crop_lo, crop_hi, k1)
        if k1 is not None:
            _check_list(*mesh_max(mesh, n_crop), k1, "metric crop list")
        out = mesh.all_reduce(
            _frame_partials(gt_l, vu, keep, fv, max_radius, tolerance,
                            distance), _SUM, ("frames",))
        return dict(zip(PARTIAL_KEYS, out))

    return step
