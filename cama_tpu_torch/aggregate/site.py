"""CAMAv2 site-level multi-scene aggregation: scenes with intersecting
portions merged into one large scene, a site.

The port of cama_tpu/aggregate/site.py.  Each clip's CAMA map lives in that
clip's SfM (scmv) frame; the ego odometry (odometry/wigo.txt) is globally
registered per location, so a per-clip Sim(3) from SfM frame to the shared
world frame is recovered by Umeyama alignment of the reconstructed chassis
trajectory against wigo at matched timestamps.  A Site then:

  * estimates T_world<-sfm (+ scale) per clip (host float64),
  * transforms every clip's lifted 3-D map instances into the world frame,
  * optionally refines the per-clip Sim(3)s jointly: Adam on the symmetric
    chamfer distance of cross-clip candidate pairs, through torch autograd
    on the site's device (`_optimize_pair_deltas`),
  * dedupes overlapping elements by symmetric chamfer distance, every
    candidate pair on the device (`_chamfer_pairs`),
  * reprojects the merged map into every member clip's cameras
    (MultiScenePipeline on the injected source 'site', which runs the
    fused_compact_project kernel on the card), and aggregates LiDAR across
    clips.

Every device step runs on `Site.device` ('cuda' unless asked otherwise) at
every size: the JAX package's host switches below 4,096 pairs dodge the
TPU's compile wall, which PyTorch does not have.

`Site.timers` (a profiling.PhaseTimers) times the phases `site_align` (each
member's Umeyama and instance transform), `site_refine` (the refinement,
from its candidate pairs to its final loss on the host) and `site_dedupe`
(the dedupe's candidate pairs, chamfer distances and keep scan), and counts
`site_instances`, `site_refine_pairs`, `site_refine_steps`,
`site_dedupe_pairs` and `site_removed`; `Site.refine_losses` holds the
refinement's objective at the start of each of its Adam steps.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from cama_tpu_torch import profiling
from cama_tpu_torch.aggregate.lidar import (
    aggregate_lidar,
    full_f32_matmul,
    save_pcd,
    voxel_downsample,
)
from cama_tpu_torch.eval.pose_metrics import umeyama_alignment
from cama_tpu_torch.io.clip import ClipReader
from cama_tpu_torch.io.scene import (
    DEFAULT_CAMA_CONFIGS,
    compile_scene,
    flatten_instances,
)
from cama_tpu_torch.ops import lift
from cama_tpu_torch.pipeline import ClipPipeline, MultiScenePipeline, resolve_device
from cama_tpu_torch.se3 import apply_seek, seek_indices, tum_to_transforms


def estimate_sim3_to_world(scene, t_max_diff=0.5, info=None):
    """Per-clip Sim(3): SfM (scmv-derived chassis) frame -> wigo world frame.

    Matches the clip's reconstructed chassis2world trajectory
    (scene.traj['cama']) against wigo poses interpolated at the same
    timestamps, then Umeyama with scale.  Returns (R [3,3], t [3], s) with
    p_world = s * R @ p_sfm + t.

    `info`: optional dict the caller owns, filled with ``sv_ratio`` and
    ``degenerate`` (near-collinear trajectory: the Umeyama roll about the
    driving axis is a free DOF).  When passed, the degeneracy warning is
    left to the caller (Site.from_clips settles the roll by refinement
    against overlapping members)."""
    sfm = scene.traj["cama"]
    ts = sfm.timestamps[:, 0]
    sfm_xyz = sfm.as_transform(True)[:, :3, 3]

    reader = scene.reader if getattr(scene, "reader", None) is not None \
        else ClipReader(scene.clip_path)
    T_w, t_w = tum_to_transforms(reader.odometry("wigo.txt"))
    idx = seek_indices(t_w, ts, t_max_diff, interpolate=True)
    matched = apply_seek(T_w, idx)
    ok = idx["valid"]
    if ok.sum() < 3:
        raise RuntimeError("not enough matched poses for site alignment")
    pos = sfm_xyz[ok]
    sv = np.linalg.svd(pos - pos.mean(0), compute_uv=False)
    ratio = float(sv[1] / sv[0]) if sv[0] > 0 else 0.0
    degenerate = sv[0] > 0 and ratio < 1e-3
    if info is not None:
        info["sv_ratio"] = ratio
        info["degenerate"] = bool(degenerate)
    elif degenerate:
        import warnings

        warnings.warn(
            f"site alignment for {scene.clip_path}: trajectory is near-"
            f"collinear (singular-value ratio {ratio:.1e}) — the "
            "Umeyama rotation has a free roll DOF; consider refine_alignment "
            "to settle it against overlapping clips", stacklevel=2)
    return umeyama_alignment(sfm_xyz[ok].T, matched[ok][:, :3, 3].T, with_scale=True)


def apply_sim3_points(points, r, t, s):
    """float64 output: the wigo world frame is global UTM, where casting to
    f32 quantizes coordinates by up to ~0.5 m, the order of the dedupe
    tolerance.  Device work recenters before any f32 cast."""
    return s * (np.asarray(points, dtype=np.float64) @ np.asarray(r).T) + t


def chamfer_distance(a, b, subsample=256):
    """Symmetric mean nearest-neighbor distance between two point sets (host
    float64).  Each set subsamples with its own fresh rng(0), so a set's
    subsample depends only on its own length: the draw _candidate_pairs
    makes once per instance."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if len(a) > subsample:
        a = a[np.random.default_rng(0).choice(len(a), subsample, replace=False)]
    if len(b) > subsample:
        b = b[np.random.default_rng(0).choice(len(b), subsample, replace=False)]
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return 0.5 * (d.min(axis=1).mean() + d.min(axis=0).mean())


PAIR_BLOCK = 128  # pairs per partial sum of the refinement loss
# device bytes one op group may hold: each group evaluates whole blocks of
# pairs at once, ~8 [S, S] float32 tensors a pair live at the peak of a
# forward and backward pass (8,192 pairs a group at S = 128)
GROUP_BYTES = 1 << 32


def _group_pairs(S):
    """Pairs per op group: whole PAIR_BLOCKs within GROUP_BYTES."""
    return max(1, GROUP_BYTES // (8 * 4 * S * S * PAIR_BLOCK)) * PAIR_BLOCK


def _pair_chamfer(a, b, wa, wb, eps=0.0):
    """[G] symmetric chamfer of the point sets a, b [G, S, 3] with weights
    wa, wb [G, S] (1/n on real points, 0 on pads, so the weighted sum is
    the mean over real points).  The squared distance keeps the JAX
    package's difference form, summed x, y, z in that order: the
    |a|^2 + |b|^2 - 2ab form changes results near the dedupe tolerance.
    torch.amin splits the gradient equally among tied minima, as JAX's min
    does; `eps` inside the sqrt keeps its gradient finite at 0."""
    d2 = ((a[:, :, None, 0] - b[:, None, :, 0]) ** 2
          + (a[:, :, None, 1] - b[:, None, :, 1]) ** 2
          + (a[:, :, None, 2] - b[:, None, :, 2]) ** 2)
    min_ab = torch.amin(torch.where(wb[:, None, :] > 0, d2, 1e30), dim=2)
    min_ba = torch.amin(torch.where(wa[:, :, None] > 0, d2, 1e30), dim=1)
    if eps:
        min_ab, min_ba = min_ab + eps, min_ba + eps
    return 0.5 * ((torch.sqrt(min_ab) * wa).sum(1)
                  + (torch.sqrt(min_ba) * wb).sum(1))


def _chamfer_pairs(pts, w, ii, jj):
    """Batched symmetric chamfer over index pairs, on the tensors' device.

    pts: [I, S, 3] float32 per-instance subsampled points (padded)
    w:   [I, S] float32 weights (1/n_i on real points, 0 on pads)
    ii, jj: [B] int64 pair indices
    Returns [B] float32 chamfer distances.  The pairs run in groups of
    whole blocks (`_group_pairs`), one set of ops per group."""
    g = _group_pairs(pts.shape[1])
    return torch.cat([
        _pair_chamfer(pts[ii[s:s + g]], pts[jj[s:s + g]],
                      w[ii[s:s + g]], w[jj[s:s + g]])
        for s in range(0, len(ii), g)])


def _chamfer_pairs_host(pts, w, ii, jj):
    """NumPy float32 mirror of _chamfer_pairs (the same formula and
    masking), PAIR_BLOCK pairs at a time."""
    out = np.empty(len(ii), np.float32)
    for s in range(0, len(ii), PAIR_BLOCK):
        bi, bj = ii[s:s + PAIR_BLOCK], jj[s:s + PAIR_BLOCK]
        a, b = pts[bi], pts[bj]
        wa, wb = w[bi], w[bj]
        d2 = np.sum((a[:, :, None, :] - b[:, None, :, :]) ** 2,
                    axis=-1, dtype=np.float32)
        inf = np.float32(1e30)
        d_ab = np.sqrt(np.min(np.where(wb[:, None, :] > 0, d2, inf), axis=2))
        d_ba = np.sqrt(np.min(np.where(wa[:, :, None] > 0, d2, inf), axis=1))
        out[s:s + PAIR_BLOCK] = 0.5 * (np.sum(d_ab * wa, axis=1)
                                       + np.sum(d_ba * wb, axis=1))
    return out


def greedy_keep(close):
    """Keep mask [I] of the dedupe: instance j is dropped when close[j, i]
    holds for an earlier instance i that is kept (earlier wins)."""
    keep = np.ones(len(close), bool)
    for j in range(len(close)):
        if close[j, :j][keep[:j]].any():
            keep[j] = False
    return keep


def _rotvec_to_matrix_np(v):
    """NumPy f64 mirror of the unnormalized Rodrigues of the refinement;
    the Sim(3) fold-in runs on the host."""
    v = np.asarray(v, np.float64)
    K = np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])
    theta2 = float(v @ v) + 1e-16
    theta = np.sqrt(theta2)
    return (np.eye(3) + (np.sin(theta) / theta) * K
            + ((1.0 - np.cos(theta)) / theta2) * (K @ K))


def _candidate_pairs(instances, subsample, tol):
    """Shared prefilter for dedupe and refinement: subsample every instance
    once (fresh rng(0) per instance, the draw chamfer_distance makes) into
    padded [I, S, 3] points + [I, S] mean-weights, and select cross-clip
    same-class pairs whose bboxes come within `tol`.

    Points are recentered by the site mean before the f32 cast: world
    coordinates are UTM-scale, where raw f32 would quantize by ~0.5 m.
    Chamfer distances are translation-invariant.

    Returns (pts, w, ii, jj, clip, center) with ii earlier / jj later
    instance indices (empty when nothing is in range); `center` [3] f64 is
    the subtracted offset.
    """
    I = len(instances)
    S = subsample
    center = np.mean(
        [np.asarray(p, np.float64).mean(0) for _, p, _ in instances], axis=0
    )
    pts = np.zeros((I, S, 3), np.float32)
    w = np.zeros((I, S), np.float32)
    for k, (_, p, _) in enumerate(instances):
        if len(p) > S:
            p = p[np.random.default_rng(0).choice(len(p), S, replace=False)]
        pts[k, : len(p)] = np.asarray(p, np.float64) - center
        w[k, : len(p)] = 1.0 / len(p)
    # dense class ids via np.unique (a hash could collide between two names)
    _, cls_id = np.unique([c for c, _, _ in instances], return_inverse=True)
    clip = np.asarray([ci for _, _, ci in instances], np.int32)
    los = np.stack([np.asarray(p, np.float64).min(0) for _, p, _ in instances])
    his = np.stack([np.asarray(p, np.float64).max(0) for _, p, _ in instances])
    jj, ii = np.nonzero(
        np.tril(np.ones((I, I), bool), -1)
        & (cls_id[:, None] == cls_id[None, :])
        & (clip[:, None] != clip[None, :])
        & np.all(
            np.maximum(los[:, None], los[None, :])
            - np.minimum(his[:, None], his[None, :]) <= tol,
            axis=-1,
        )
    )
    return pts, w, ii, jj, clip, center


class Site:
    """A merged multi-clip site map in the shared wigo-world frame.

    device: where dedupe, refinement and the member reprojection run;
    'cuda' (raises without a card) unless the caller asks for 'cpu'.  By
    default it comes from configs['device'], else 'cuda'."""

    def __init__(self, name="site", configs=None, device=None):
        self.name = name
        self.configs = {**DEFAULT_CAMA_CONFIGS, **(configs or {})}
        self.device = resolve_device(device or self.configs.pop("device", None)
                                     or "cuda")
        self.clips = []  # (clip_path, scene, (r, t, s))
        self.instances = []  # (class_name, points [P, 3] world, clip_index)
        # clip indices whose Umeyama alignment had a free roll DOF (near-
        # collinear trajectory) and have NOT been settled by refinement yet
        self.degenerate_clips = set()
        self.timers = profiling.PhaseTimers()
        # the objective at the start of each Adam step of the last refinement
        self.refine_losses = np.zeros(0)

    @classmethod
    def from_clips(cls, clip_paths, configs=None, dedupe_tol=0.5, name="site",
                   refine=False, scenes=None, device=None):
        """Build a site from member clips.  Pass `scenes` (parallel to
        clip_paths) to reuse already-compiled Scenes: the CLI hands over the
        pipelines' scenes instead of lifting every member again."""
        site = cls(name=name, configs=configs, device=device)
        configs = site.configs
        if scenes is not None and len(scenes) != len(clip_paths):
            raise ValueError(
                f"scenes ({len(scenes)}) must parallel clip_paths "
                f"({len(clip_paths)})")
        for i, path in enumerate(clip_paths):
            scene = scenes[i] if scenes is not None else None
            if scene is not None and "cama" not in scene.flat:
                raise ValueError(
                    f"prebuilt scene for {path} lacks the 'cama' source")
            if scene is None:
                cache = None
                if configs.get("scene_cache", True):
                    # not the pipeline's (cama, nuscenes) cache file: the key
                    # embeds the source tuple, and two keys alternating on
                    # one file would recompile every time
                    cache = os.path.join(str(path), ".cama_tpu",
                                         "scene_cache_cama.npz")
                scene = compile_scene(path, configs, sources=("cama",),
                                      cache=cache)
            site.add_clip(path, scene)
        # a degenerate (near-collinear) member's Umeyama roll is a free DOF:
        # settle it against overlapping members
        if refine or site.degenerate_clips:
            site.refine_alignment()
        site.warn_unsettled()
        site.dedupe(tol=dedupe_tol)
        return site

    def add_clip(self, clip_path, scene):
        with self.timers.phase("site_align"):
            info = {}
            r, t, s = estimate_sim3_to_world(scene, info=info)
            ci = len(self.clips)
            if info.get("degenerate"):
                self.degenerate_clips.add(ci)
            self.clips.append((str(clip_path), scene, (r, t, s)))
            instances = lift.unflatten_to_instances(scene.flat["cama"])
            for inst in instances:
                world_pts = apply_sim3_points(inst["points"], r, t, s)
                self.instances.append((inst["class"], world_pts, ci))
        self.timers.add("site_instances", 0.0, len(instances))

    def warn_unsettled(self):
        """Warn for member clips whose free-roll (near-collinear) alignment
        could not be settled: after refinement they still had no cross-clip
        correspondences to optimize against."""
        if not self.degenerate_clips:
            return
        import warnings

        for ci in sorted(self.degenerate_clips):
            warnings.warn(
                f"site {self.name!r}: member {self.clips[ci][0]} has a near-"
                "collinear trajectory (free Umeyama roll DOF) and no "
                "overlapping map elements in other members to settle it "
                "against — its merged elements may carry an arbitrary roll",
                stacklevel=2)

    def dedupe(self, tol=0.5, subsample=256):
        """Drop map elements that duplicate an earlier clip's element of the
        same class within `tol` m symmetric chamfer distance (the
        intersecting portions shared by overlapping scenes).

        Every instance is subsampled once into a padded [I, S, 3] tensor,
        the bbox/class/clip prefilter picks candidate pairs on the host,
        and every candidate chamfer runs on the site's device
        (_chamfer_pairs).  The greedy keep scan (the earlier instance wins)
        runs on the host over the resulting booleans.  Returns the count
        removed."""
        I = len(self.instances)
        if I < 2:
            return 0
        with self.timers.phase("site_dedupe"):
            pts, w, ii, jj, _, _ = _candidate_pairs(self.instances, subsample, tol)
            close = np.zeros((I, I), bool)
            if len(ii):
                dev = self.device
                dvals = _chamfer_pairs(
                    torch.from_numpy(pts).to(dev), torch.from_numpy(w).to(dev),
                    torch.from_numpy(ii).to(dev), torch.from_numpy(jj).to(dev))
                close[jj, ii] = dvals.cpu().numpy() < tol

            keep_mask = greedy_keep(close)
            removed = int((~keep_mask).sum())
            self.instances = [inst for inst, k in zip(self.instances, keep_mask) if k]
        self.timers.add("site_dedupe_pairs", 0.0, len(ii))
        self.timers.add("site_removed", 0.0, removed)
        return removed

    # ---------------- joint alignment refinement ----------------

    def refine_alignment(self, iters=600, lr=2e-2, tol=2.0, subsample=128,
                         backend="auto"):
        """Joint Sim(3) refinement across clips: a residual delta-Sim(3) per
        clip (clip 0 anchored) is optimized by Adam on the mean symmetric
        chamfer distance of the cross-clip candidate pairs, differentiated
        by torch autograd.  Parameters are (so(3) rotation vector,
        translation, log-scale); the deltas compose onto the stored Sim(3)s
        and instance points afterwards.

        backend: 'auto' and 'device' run on the site's device, 'host' on
        CPU tensors.

        Returns (chamfer_before, chamfer_after) mean pair distances; no-op
        (returns (0, 0)) when no cross-clip pairs exist within `tol`.
        """
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"refine_alignment backend {backend!r} "
                             "(expected auto|host|device)")
        I = len(self.instances)
        n_clips = len(self.clips)
        if I < 2 or n_clips < 2:
            return 0.0, 0.0
        with self.timers.phase("site_refine"):
            pts, w, ii, jj, clip, world_center = _candidate_pairs(self.instances, subsample, tol)
            self.timers.add("site_refine_pairs", 0.0, len(ii))
            if len(ii) == 0:
                return 0.0, 0.0
            # clips with cross-clip correspondences get their free-roll DOF
            # settled by the chamfer objective (or confirmed already settled
            # when refinement declines)
            self.degenerate_clips -= ({int(c) for c in clip[ii]}
                                      | {int(c) for c in clip[jj]})
            dev = torch.device("cpu") if backend == "host" else self.device
            losses = []
            deltas, before, after, center_np = _optimize_pair_deltas(
                pts, w, ii, jj, clip, n_clips, iters, lr, device=dev, losses=losses)
            self.refine_losses = np.asarray(losses, np.float64)
            self.timers.add("site_refine_steps", 0.0, len(losses))
            return self._apply_refine_deltas(deltas, before, after, center_np,
                                             world_center, n_clips)

    def _apply_refine_deltas(self, deltas, before, after, center_np,
                             world_center, n_clips):
        """Fold optimized delta-Sim(3)s into the stored transforms and
        world-frame instance points (deltas=None: refinement declined,
        iters == 0 or it would have made the site worse)."""
        if deltas is None:
            return before, after
        rot, tns, lgs = deltas
        # the optimization ran in recentered coordinates, so the
        # world-frame pivot is world_center + the local centroid
        cen = np.asarray(world_center, np.float64) + center_np
        applied = []
        for c in range(n_clips):
            Rd = _rotvec_to_matrix_np(rot[c])
            sd = float(np.exp(lgs[c]))
            td = tns[c].astype(np.float64)
            applied.append((Rd, td, sd))
            path, scene, (r0, t0, s0) = self.clips[c]
            # p' = sd Rd (p - cen) + cen + td with p = s0 R0 q + t0
            r_new = Rd @ np.asarray(r0)
            s_new = sd * s0
            t_new = sd * (Rd @ (np.asarray(t0, np.float64) - cen)) + cen + td
            self.clips[c] = (path, scene, (r_new, t_new, s_new))
        self.instances = [
            (cn, applied[ci][2] * ((np.asarray(p, np.float64) - cen)
                                   @ applied[ci][0].T) + cen + applied[ci][1],
             ci)
            for cn, p, ci in self.instances
        ]
        return before, after

    # ---------------- outputs ----------------

    def flat_points(self, class_names=None, pad_multiple=1024):
        """Merged map as FlatPoints in raw world coordinates.  World
        coordinates are UTM-scale, where f32 quantizes by ~0.5 m; prefer
        flat_points_recentered for anything feeding device work."""
        return flatten_instances(
            [(c, np.asarray(p, np.float64).astype(np.float32))
             for c, p, _ in self.instances],
            class_names=class_names, pad_multiple=pad_multiple,
        )

    def flat_points_recentered(self, class_names=None, pad_multiple=1024):
        """(FlatPoints, center [3] f64): the site centroid subtracted before
        the f32 layout, so UTM-scale coordinates keep sub-mm resolution."""
        pts = [(c, np.asarray(p, np.float64)) for c, p, _ in self.instances]
        center = (np.mean([p.mean(0) for _, p in pts], axis=0)
                  if pts else np.zeros(3))
        flat = flatten_instances(
            [(c, (p - center).astype(np.float32)) for c, p in pts],
            class_names=class_names, pad_multiple=pad_multiple,
        )
        return flat, center

    def save_labels_json(self, path):
        """Site map as a reference-schema label JSON (world-frame meters,
        xy only; consumable by the nuScenes lifting path)."""
        records = []
        for cls_name, pts, _ in self.instances:
            records.append({
                "attrs": {"type": cls_name},
                "data": np.asarray(pts)[:, :2].tolist(),
                "id": -1, "luid": "site", "point_attrs": [[] for _ in range(len(pts))],
                "shape_type": "polyline", "struct_type": "parsing", "track_id": -1,
            })
        with open(path, "w") as f:
            json.dump(records, f)
        return path

    def save_pcd(self, path):
        pts = np.concatenate([p for _, p, _ in self.instances]) if self.instances else np.zeros((0, 3))
        colors = (
            np.concatenate([
                np.tile(lift.COLOR_MAPS.get(c, lift.COLOR_MAPS["Crosswalk_Line"]), (len(p), 1))
                for c, p, _ in self.instances
            ])
            if self.instances else None
        )
        return save_pcd(path, pts, colors)

    def pipeline_for_clip(self, clip_index, chunk=8):
        """A ClipPipeline on the site's device that reprojects the MERGED
        site map into one member clip's cameras: site-frame points go back
        through the clip's inverse Sim(3) into its SfM frame and ride its
        own pose chain, so head/tail frames a single clip's map misses are
        covered by the site.  The injected source is named 'site'."""
        path, scene, (r, t, s) = self.clips[clip_index]
        # invert p_world = s R p + t  ->  p_sfm = (1/s) R^T (p_world - t)
        rinv = np.asarray(r).T
        instances = []
        for cls_name, pts, _ in self.instances:
            local = ((np.asarray(pts, np.float64) - t) @ rinv.T) / s
            instances.append((cls_name, local.astype(np.float32)))
        scene.flat["site"] = flatten_instances(
            instances, class_names=scene.flat["cama"].class_names)
        scene.traj["site"] = scene.traj["cama"]
        return ClipPipeline(self.configs, clip_path=path, scene=scene,
                            chunk=chunk, device=self.device)

    def _member_pipelines(self, chunk):
        return [self.pipeline_for_clip(i, chunk=chunk)
                for i in range(len(self.clips))]

    def member_overlay_rasters(self, chunk=8, max_in_flight=3):
        """Site-scale serving: reproject the merged map into every member
        clip's cameras, one chunk of every member at once
        (MultiScenePipeline over the injected 'site' source).  Yields
        (clip_index, image_idx, cls_raster)."""
        msp = MultiScenePipeline(self._member_pipelines(chunk), source="site",
                                 chunk=chunk)
        yield from msp.iter_overlay_rasters(max_in_flight=max_in_flight)

    def member_overlay_videos(self, out_dir, prefix=None, chunk=8, fps=10,
                              preset=None):
        """Write a site-merged overlay video for every member clip: each
        member sees the whole site's map through its own cameras.  Yields
        (video_path, frames_written)."""
        prefix = prefix or self.name
        pipes = self._member_pipelines(chunk)
        # normpath (trailing slashes give basename '') + uniquify: two
        # same-named clip dirs from different roots must not collapse onto
        # one .mp4 with two encoders writing it
        names, seen = [], {}
        for p in pipes:
            base = os.path.basename(os.path.normpath(str(p.scene.clip_path)))
            n = seen.get(base, 0)
            seen[base] = n + 1
            names.append(base if n == 0 else f"{base}-{n + 1}")
        paths = [
            {"site": os.path.join(out_dir, f"{prefix}_{name}_site.mp4")}
            for name in names
        ]
        if len(pipes) > 1:
            msp = MultiScenePipeline(pipes, source="site", chunk=chunk)
            counts = msp.write_videos(paths, fps=fps, preset=preset)
        else:
            counts = [pipes[0].write_videos(paths[0], fps=fps, preset=preset)]
        for pth, cnt in zip(paths, counts):
            yield pth["site"], cnt["site"]

    def aggregate_lidar(self, voxel=0.2, every=2, **kw):
        """Cross-clip LiDAR aggregation: each clip's sweeps through its own
        reconstructed chain, built with this site's configs (the chain the
        Sim(3) was estimated from), on the site's device, then Sim(3) into
        the site frame.  with_intensity=True is kept through the transform;
        voxel dedup drops it."""
        kw.setdefault("configs", self.configs)
        kw.setdefault("device", self.device)
        clouds = []
        for path, scene, (r, t, s) in self.clips:
            pts = aggregate_lidar(path, pose_source="cama", every=every, **kw)
            if not len(pts):
                continue
            xyz = apply_sim3_points(pts[:, :3], r, t, s)
            clouds.append(np.concatenate([xyz, pts[:, 3:]], axis=1)
                          if pts.shape[1] > 3 else xyz)
        if not clouds:
            return np.zeros((0, 3), np.float32)
        merged = np.concatenate(clouds)
        if voxel:
            merged = voxel_downsample(merged[:, :3], voxel)
        return merged


def _rotvec_to_matrix(v):
    """Batched unnormalized Rodrigues, [n, 3] -> [n, 3, 3]: smooth at v = 0
    (the norm has a NaN gradient there)."""
    z = torch.zeros_like(v[:, 0])
    K = torch.stack([
        torch.stack([z, -v[:, 2], v[:, 1]], -1),
        torch.stack([v[:, 2], z, -v[:, 0]], -1),
        torch.stack([-v[:, 1], v[:, 0], z], -1)], -2)
    theta2 = (v * v).sum(-1) + 1e-16
    theta = torch.sqrt(theta2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return (eye + (torch.sin(theta) / theta)[:, None, None] * K
            + ((1 - torch.cos(theta)) / theta2)[:, None, None] * (K @ K))


def _delta_sim3(params):
    """(R [n, 3, 3], s [n]) of the clips' delta Sim(3)s."""
    return _rotvec_to_matrix(params["rot"]), torch.exp(params["log_s"])


def _pair_loss_blocks(R, s, t, data, lo, hi, eps=1e-12):
    """[(hi - lo) / PAIR_BLOCK] sums of the per-pair chamfer over pairs
    lo:hi (whole blocks; the pairs past the last real one count 0), each
    clip's delta Sim(3) (R, s, t) applied about the site centroid, so
    rotation and scale gradients do not fight translation."""
    def moved(idx):
        ci = data["clip"][idx]
        p = data["pts"][idx] - data["center"]
        return (s[ci][:, None, None] * (p @ R[ci].transpose(1, 2))
                + data["center"] + t[ci][:, None, :])

    bi, bj = data["ii"][lo:hi], data["jj"][lo:hi]
    per_pair = _pair_chamfer(moved(bi), moved(bj), data["w"][bi],
                             data["w"][bj], eps)
    pad = hi - lo - len(per_pair)
    return torch.nn.functional.pad(per_pair, (0, pad)).view(-1, PAIR_BLOCK).sum(1)


def _groups(data):
    """(lo, hi) of the op groups: whole blocks, the last padded."""
    g = _group_pairs(data["pts"].shape[1])
    n = -(-len(data["ii"]) // PAIR_BLOCK) * PAIR_BLOCK
    return [(lo, min(lo + g, n)) for lo in range(0, n, g)]


def pair_loss(params, data):
    """The refinement objective: the mean symmetric chamfer over the pairs.
    Per-pair values are summed over each PAIR_BLOCK (the pad past the last
    pair counting 0), then over the blocks, then divided by the pair count
    (the JAX package's reduction order)."""
    with full_f32_matmul():
        R, s = _delta_sim3(params)
        blocks = [_pair_loss_blocks(R, s, params["t"], data, lo, hi)
                  for lo, hi in _groups(data)]
    return torch.cat(blocks).sum() / len(data["ii"])


def refine_data(pts, w, ii, jj, clip, device):
    """The refinement's inputs as tensors on `device`, and the local
    centroid (float32, on the host as the JAX package computes it)."""
    center = pts.reshape(-1, 3)[w.reshape(-1) > 0].mean(0)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    data = {"pts": put(pts), "w": put(w), "ii": put(ii.astype(np.int64)),
            "jj": put(jj.astype(np.int64)), "clip": put(clip.astype(np.int64)),
            "center": put(center)}
    return data, center


def refine_state(n_clips, lr, device):
    """(params, optimizer, anchor) at the start of a refinement: zero
    deltas (rotation vector, translation, log-scale) per clip, Adam, and
    the mask that holds clip 0."""
    params = {k: torch.zeros(shape, dtype=torch.float32, device=device,
                             requires_grad=True)
              for k, shape in (("rot", (n_clips, 3)), ("t", (n_clips, 3)),
                               ("log_s", (n_clips,)))}
    anchor = (torch.arange(n_clips, device=device) != 0).to(torch.float32)
    return params, torch.optim.Adam(params.values(), lr=lr), anchor


def _refine_step(params, opt, anchor, data):
    """One Adam step on the refinement objective; returns the loss at the
    input parameters (a tensor on the device, not fetched).  The pairs run
    in groups of whole blocks, each group's backward pass right after its
    forward, so the saved tensors of one group are held at a time; the
    groups' passes stop at the delta Sim(3)s' R and s, whose own backward
    runs once a step.  Clip 0's gradient is zeroed before the update."""
    n_pairs = len(data["ii"])
    opt.zero_grad(set_to_none=False)
    sums = []
    with full_f32_matmul():
        R, s = _delta_sim3(params)
        R_, s_ = R.detach().requires_grad_(), s.detach().requires_grad_()
        for lo, hi in _groups(data):
            blocks = _pair_loss_blocks(R_, s_, params["t"], data, lo, hi)
            (blocks.sum() / n_pairs).backward()
            sums.append(blocks.detach())
        torch.autograd.backward((R, s), (R_.grad, s_.grad))
    with torch.no_grad():
        for p in params.values():
            p.grad.mul_(anchor if p.dim() == 1 else anchor[:, None])
    opt.step()
    return torch.cat(sums).sum() / n_pairs


def _optimize_pair_deltas(pts, w, ii, jj, clip, n_clips, iters, lr,
                          device="cuda", losses=None):
    """The refinement core: Adam (torch.optim.Adam, the defaults of optax's
    adam) on the delta parameters, gradients by autograd, on `device`.
    ii, jj are the candidate pairs, not padded: the pad of the last block
    is a zero sum, not computed.  Nothing syncs with the host inside the
    loop: each step's loss stays on the device until the end, when all are
    fetched at once (into the list `losses`, when given).
    Returns (deltas | None, chamfer_before, chamfer_after,
    local_centroid): deltas = (rot [n, 3], t [n, 3], log_s [n]) NumPy,
    None when refinement is declined (iters == 0, or it would have made
    the site worse)."""
    device = torch.device(device)
    data, center = refine_data(pts, w, ii, jj, clip, device)
    center_np = np.asarray(center, np.float64)
    params, opt, anchor = refine_state(n_clips, lr, device)
    steps = [_refine_step(params, opt, anchor, data) for _ in range(iters)]
    with torch.no_grad():  # the probe: the loss at the final parameters
        after = float(pair_loss(params, data))
    if not steps:  # iters == 0: nothing optimized
        return None, after, after, center_np
    steps = torch.stack(steps).cpu().numpy()
    if losses is not None:
        losses.extend(steps.tolist())
    before = float(steps[0])
    if after >= before:  # refinement must never make the site worse
        return None, before, before, center_np
    return (tuple(params[k].detach().cpu().numpy() for k in ("rot", "t", "log_s")),
            before, after, center_np)


def main(argv=None):
    """cama-tpu-torch-site: merge clips covering intersecting road into one
    site map."""
    import argparse

    parser = argparse.ArgumentParser(description="CAMAv2 site-level multi-scene aggregation")
    parser.add_argument("--clips", nargs="+", required=True, help="clip directories")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--name", default="site")
    parser.add_argument("--dedupe-tol", type=float, default=0.5)
    parser.add_argument("--refine", action="store_true",
                        help="jointly refine per-clip Sim(3) (Adam on the "
                             "cross-clip chamfer) before dedupe")
    parser.add_argument("--lidar", action="store_true", help="also aggregate LiDAR")
    parser.add_argument("--lidar-voxel", type=float, default=0.2)
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    site = Site.from_clips(args.clips, dedupe_tol=args.dedupe_tol, name=args.name,
                           refine=args.refine, device=args.device)
    labels = site.save_labels_json(os.path.join(args.out_dir, f"{args.name}_labels.json"))
    pcd = site.save_pcd(os.path.join(args.out_dir, f"{args.name}_map.pcd"))
    print(f"{len(site.clips)} clips -> {len(site.instances)} map elements")
    print(f"labels: {labels}\nmap pcd: {pcd}")
    if args.lidar:
        cloud = site.aggregate_lidar(voxel=args.lidar_voxel)
        out = save_pcd(os.path.join(args.out_dir, f"{args.name}_lidar.pcd"), cloud)
        print(f"lidar: {len(cloud)} points -> {out}")


if __name__ == "__main__":
    main()
