"""The overlay video frame of one (scene, source, frame), from the clip
alone: the undistorted base images and every kept label point painted on
them with a radius-2 disc (the 13 pixels of cv2.circle(radius=2,
thickness=-1)), later points over earlier ones, in the 3x2 camera mosaic
of cama/tools.py:22-25.

A point is kept in a camera when it lies inside the chassis crop box
(inclusive), in front of the camera (z > 0 before the division) and
inside the image, 0 <= u < W and 0 <= v < H; it paints around
(floor(v), floor(u)).  The projection chain runs in `dtype`.
"""
from __future__ import annotations

import numpy as np
import torch

from camabench.reference.scene import LANE_BGR, OTHER_BGR

GRID = [["camera_front_left", "camera_front", "camera_front_right"],
        ["camera_rear_left", "camera_rear", "camera_rear_right"]]
# (dy, dx) of the radius-2 disc
DISC = np.array([(-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1), (0, 0),
                 (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0)], np.int64)


def crop_bounds(crop_m):
    lo = np.array([crop_m["x"][0], crop_m["y"][0], crop_m["z"][0]])
    hi = np.array([crop_m["x"][1], crop_m["y"][1], crop_m["z"][1]])
    return lo, hi


def project(points, chassis2world, chassis2cam, K, size, crop_m,
            dtype=torch.float64):
    """Per camera (v, u) pixel floats [P] and the kept mask [P], as float64
    NumPy arrays; the chain world -> chassis -> camera -> pixel runs in
    `dtype`."""
    lo, hi = crop_bounds(crop_m)
    h, w = size
    p = torch.as_tensor(points, dtype=torch.float64).to(dtype)
    ph = torch.cat([p, torch.ones_like(p[:, :1])], 1)
    w2c = torch.as_tensor(np.linalg.inv(chassis2world)).to(dtype)
    ch = ph @ w2c.T                                     # [P, 4]
    lo_t = torch.as_tensor(lo).to(dtype)
    hi_t = torch.as_tensor(hi).to(dtype)
    sel = torch.nonzero(((ch[:, :3] >= lo_t) & (ch[:, :3] <= hi_t)).all(1))[:, 0]
    ch = ch[sel]
    out = []
    for c in range(len(chassis2cam)):
        P = torch.as_tensor(K[c] @ chassis2cam[c][:3]).to(dtype)  # [3, 4]
        pix = ch @ P.T
        z = pix[:, 2]
        front = z > 0
        zs = torch.where(front, z, torch.ones_like(z))
        u, v = pix[:, 0] / zs, pix[:, 1] / zs
        ok = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        full = [np.zeros(len(points)), np.zeros(len(points)), np.zeros(len(points), bool)]
        for arr, val in zip(full, (v.double(), u.double(), ok)):
            arr[sel.numpy()] = val.numpy()
        out.append(tuple(full))
    return out


def counts(points, chassis2world, clip, crop_m):
    """(points in the crop, [C] kept, [C] kept after dropping a point whose
    successor is kept on the same pixel) of one frame, at float64."""
    proj = project(points, chassis2world, clip.chassis2cam, clip.K_out,
                   clip.output_size, crop_m)
    w = clip.output_size[1]
    kept, eff = [], []
    for v, u, keep in proj:
        pix = np.where(keep, np.floor(v) * w + np.floor(u), -1)
        dup = np.zeros_like(keep)
        dup[:-1] = keep[:-1] & keep[1:] & (pix[:-1] == pix[1:])
        kept.append(int(keep.sum()))
        eff.append(int((keep & ~dup).sum()))
    lo, hi = crop_bounds(crop_m)
    ch = (np.concatenate([points, np.ones((len(points), 1))], 1)
          @ np.linalg.inv(chassis2world).T)[:, :3]
    n_crop = int(((ch >= lo) & (ch <= hi)).all(1).sum())
    return n_crop, kept, eff


def paint(image, v, u, keep, lane):
    """Paint the kept points onto image [H, W, 3] uint8 in place; returns the
    painted mask [H, W]."""
    h, w = image.shape[:2]
    idx = np.flatnonzero(keep)
    py = np.floor(v[idx]).astype(np.int64)[:, None] + DISC[None, :, 0]
    px = np.floor(u[idx]).astype(np.int64)[:, None] + DISC[None, :, 1]
    order = np.broadcast_to(np.arange(len(idx))[:, None], py.shape)
    ok = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    last = np.full(h * w, -1, np.int64)
    np.maximum.at(last, (py * w + px)[ok], order[ok])
    painted = last >= 0
    colors = np.where(lane[idx][last[painted], None], LANE_BGR, OTHER_BGR)
    image.reshape(-1, 3)[painted] = colors
    return painted.reshape(h, w)


def undistort_map(K_orig, d, K_new, size):
    """(mapx, mapy) [h, w] float64: the source pixel each output pixel
    samples, for the pinhole model with radial k1..k6 and tangential p1, p2
    distortion (OpenCV's layout) and no rectification."""
    h, w = size
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    iK = np.linalg.inv(K_new)
    x = iK[0, 0] * u + iK[0, 1] * v + iK[0, 2]
    y = iK[1, 0] * u + iK[1, 1] * v + iK[1, 2]
    z = iK[2, 0] * u + iK[2, 1] * v + iK[2, 2]
    x, y = x / z, y / z
    r2 = x * x + y * y
    rad = (1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3) / (1 + k4 * r2 + k5 * r2 ** 2 + k6 * r2 ** 3)
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return (K_orig[0, 0] * xd + K_orig[0, 1] * yd + K_orig[0, 2],
            K_orig[1, 0] * xd + K_orig[1, 1] * yd + K_orig[1, 2])


class BilinearSampler:
    """Bilinear sampling at (mapy, mapx) of images of one source shape,
    zero outside the image, rounded to uint8; the taps and weights are
    worked out once."""

    def __init__(self, mapx, mapy, src_shape):
        H, W = src_shape
        x0, y0 = np.floor(mapx), np.floor(mapy)
        fx, fy = (mapx - x0).ravel(), (mapy - y0).ravel()
        x0, y0 = x0.astype(np.int64).ravel(), y0.astype(np.int64).ravel()
        self.taps, self.weights = [], []
        for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                            (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
            yy, xx = y0 + dy, x0 + dx
            ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            self.taps.append(np.where(ok, yy * W + xx, H * W))  # H*W: a zero pixel
            self.weights.append(wgt[:, None])
        self.shape = mapx.shape

    def __call__(self, image):
        flat = np.concatenate([image.reshape(-1, image.shape[-1]),
                               np.zeros((1, image.shape[-1]), image.dtype)])
        out = sum(flat[t] * w for t, w in zip(self.taps, self.weights))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(self.shape + (-1,))


class NearestSampler:
    """Nearest sampling at (mapy, mapx) rounded half to even, zero outside,
    of images of one source shape."""

    def __init__(self, mapx, mapy, src_shape):
        H, W = src_shape
        x, y = np.rint(mapx).astype(np.int64), np.rint(mapy).astype(np.int64)
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        self.tap = np.where(ok, y * W + x, H * W).ravel()
        self.shape = mapx.shape

    def __call__(self, image):
        flat = np.concatenate([image.reshape(-1), np.zeros(1, image.dtype)])
        return flat[self.tap].reshape(self.shape)


class Renderer:
    """Reference mosaics of one clip; base images are undistorted once per
    frame and reused across sources."""

    def __init__(self, clip, crop_m, dtype=torch.float64):
        self.clip, self.crop_m, self.dtype = clip, crop_m, dtype
        self._samplers = [
            BilinearSampler(*undistort_map(clip.K_orig[c], clip.d[c], clip.K_out[c],
                                           clip.output_size), clip.image_size)
            for c in range(len(clip.cameras))]
        self._bases = {}
        self._poses = {}

    def base(self, image_idx):
        import cv2

        if image_idx not in self._bases:
            self._bases = {image_idx: [
                self._samplers[c](cv2.imread(self._jpeg(cam, image_idx)))
                for c, cam in enumerate(self.clip.cameras)]}
        return self._bases[image_idx]

    def _jpeg(self, cam, image_idx):
        import os

        return os.path.join(self.clip.path, cam, f"{self.clip.sync_ms[cam][image_idx]}.jpg")

    def pose(self, source, image_idx):
        if source not in self._poses:
            from camabench.reference.scene import served_frames

            self._poses[source] = dict(served_frames(self.clip, source))
        return self._poses[source].get(image_idx)

    def mosaic(self, source, image_idx):
        """(mosaic [2h, 3w, 3] uint8, painted mask [2h, 3w]) of one frame."""
        clip = self.clip
        h, w = clip.output_size
        proj = project(clip.points[source], self.pose(source, image_idx),
                       clip.chassis2cam, clip.K_out, clip.output_size,
                       self.crop_m, self.dtype)
        out = np.zeros((2 * h, 3 * w, 3), np.uint8)
        mask = np.zeros((2 * h, 3 * w), bool)
        bases = self.base(image_idx)
        for c, cam in enumerate(clip.cameras):
            r, col = next((r, row.index(cam)) for r, row in enumerate(GRID) if cam in row)
            img = bases[c].copy()
            m = paint(img, *proj[c], clip.lane[source])
            out[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
            mask[r * h:(r + 1) * h, col * w:(col + 1) * w] = m
        return out, mask
