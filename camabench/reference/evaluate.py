"""Scene map-evaluation sums from the clip alone (CAMA's metrics as the
map-eval entry defines them).

For every served frame with ground truth and every camera: the instance
PNG (at the source resolution) is resampled to the output size through the
undistortion map with nearest sampling; its non-zero pixels are the mask.
Each kept label point (render.project) lands on pixel (floor(v), floor(u)).
With dist the Chebyshev (chessboard) distance to the mask, capped at
max(max_radius, tolerance + 1) (the cap where a camera has no mask):

  SRE       = sum over points of min(dist, max_radius) / points
  precision = points with dist <= tolerance / points
  recall    = mask pixels within Chebyshev distance tolerance of a point's
              pixel / mask pixels
  F1        = 2 P R / (P + R)

Distances are exact: the distance along each row to the nearest mask
pixel, then the least over row offsets, in plain PyTorch on the CPU, a
block of images at a time.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from camabench.reference.render import NearestSampler, project, undistort_map
from camabench.reference.scene import served_frames


def _row_distance(mask, cap):
    """[N, H, W] bool -> int64 distance along each row to the nearest True,
    capped at cap."""
    W = mask.shape[-1]
    x = torch.arange(W)
    big = W + cap + 1
    left = torch.cummax(torch.where(mask, x, -big), -1).values
    right = torch.flip(torch.cummin(torch.flip(torch.where(mask, x, 2 * big), [-1]), -1).values, [-1])
    return torch.minimum(x - left, right - x).clamp(max=cap)


def _chebyshev_at(g, vi, ui, cap):
    """min(Chebyshev distance to the mask, cap) at pixels (vi, ui) of one
    image, from its row distances g [H, W]: the least over row offsets dy
    of max(|dy|, g[v + dy, u])."""
    H = g.shape[0]
    best = torch.full(vi.shape, cap, dtype=torch.int64)
    for dy in range(-cap, cap + 1):
        vv = vi + dy
        ok = (vv >= 0) & (vv < H)
        gv = g[vv.clamp(0, H - 1), ui].clamp(min=abs(dy))
        best = torch.where(ok, torch.minimum(best, gv), best)
    return best


def evaluate(clip, source, crop_m, tolerance=5, max_radius=20,
             dtype=torch.float64, block=12):
    """{"SRE", "precision", "recall", "f1", "n_points", "gt_pixels",
    "frames_evaluated"} of one source of a clip."""
    import cv2

    h, w = clip.output_size
    samplers = [NearestSampler(*undistort_map(clip.K_orig[c], clip.d[c], clip.K_out[c],
                                              (h, w)), clip.image_size)
                for c in range(len(clip.cameras))]
    cap = max(max_radius, tolerance + 1)
    sums = dict(sre=0.0, n=0.0, hit=0.0, gt=0.0, covered=0.0)
    frames = 0
    block_jobs = []

    def flush(part):
        mask = torch.from_numpy(np.stack([m for m, _, _ in part]))
        g = _row_distance(mask, cap)
        pts = torch.zeros(mask.shape, dtype=torch.float32)
        for i, (_, vi, ui) in enumerate(part):
            pix, n = np.unique(vi * w + ui, return_counts=True)
            vv, uu = torch.from_numpy(pix // w), torch.from_numpy(pix % w)
            n = torch.from_numpy(n).double()
            d = _chebyshev_at(g[i], vv, uu, cap).double()
            sums["sre"] += float((n * d.clamp(max=max_radius)).sum())
            sums["n"] += float(n.sum())
            sums["hit"] += float((n * (d <= tolerance)).sum())
            pts[i].view(-1)[torch.from_numpy(pix)] = 1.0
        k = 2 * tolerance + 1
        near = torch.nn.functional.max_pool2d(pts[:, None], (1, k), stride=1,
                                              padding=(0, tolerance))
        near = torch.nn.functional.max_pool2d(near, (k, 1), stride=1,
                                              padding=(tolerance, 0))[:, 0] > 0
        sums["gt"] += float(mask.sum())
        sums["covered"] += float((mask & near).sum())

    def load(item):
        idx, pose = item
        paths = [os.path.join(clip.path, f"lane_ins_{cam}",
                              f"{clip.sync_ms[cam][idx]}.png") for cam in clip.cameras]
        if not all(os.path.exists(p) for p in paths):
            return None
        proj = project(clip.points[source], pose, clip.chassis2cam, clip.K_out,
                       (h, w), crop_m, dtype)
        out = []
        for c, path in enumerate(paths):
            ids = samplers[c](cv2.imread(path, cv2.IMREAD_ANYDEPTH))
            v, u, keep = proj[c]
            out.append((ids > 0, np.floor(v[keep]).astype(np.int64),
                        np.floor(u[keep]).astype(np.int64)))
        return out

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        for images in pool.map(load, served_frames(clip, source)):
            if images is None:
                continue
            frames += 1
            block_jobs += images
            if len(block_jobs) >= block:
                flush(block_jobs)
                block_jobs = []
    if block_jobs:
        flush(block_jobs)
    p = sums["hit"] / sums["n"] if sums["n"] else 0.0
    r = sums["covered"] / sums["gt"] if sums["gt"] else 0.0
    return {"SRE": sums["sre"] / sums["n"] if sums["n"] else float("nan"),
            "precision": p, "recall": r,
            "f1": 2 * p * r / (p + r) if p + r else 0.0,
            "n_points": sums["n"], "gt_pixels": sums["gt"],
            "frames_evaluated": frames}
