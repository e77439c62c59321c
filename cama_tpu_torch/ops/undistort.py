"""Undistortion + resize remap grids, computed once per camera, and their
application on the host or the device.

Counterpart of cama_tpu/ops/undistort.py.  `compute_remap` replicates
OpenCV's initUndistortRectifyMap math (pinhole + radial k1..k6 / tangential
p1 p2, identity rectification); `remap_host` applies the grid with
cv2.remap, so base images are byte-exact to the reference renderer, and
falls back to `remap_bilinear` on CPU tensors where cv2 is missing;
`remap_bilinear` is the bilinear gather in plain tensor ops, on whatever
device its tensors lie (tests/test_torch_composite.py holds it to JAX's).
"""
from __future__ import annotations

import numpy as np
import torch


def compute_remap(K_orig, d, K_new, out_size):
    """Build (mapx, mapy) float32 arrays of shape out_size=(h, w).

    d follows OpenCV layout [k1, k2, p1, p2, k3, k4, k5, k6] (shorter arrays
    are zero-padded).  Matches cv2.initUndistortRectifyMap(K_orig, d, None,
    K_new, (w, h), cv2.CV_32FC1).
    """
    h, w = out_size
    K_orig = np.asarray(K_orig, dtype=np.float64)
    K_new = np.asarray(K_new, dtype=np.float64)
    dd = np.zeros(8)
    d = np.asarray(d, dtype=np.float64).reshape(-1)
    dd[: len(d)] = d
    k1, k2, p1, p2, k3, k4, k5, k6 = dd

    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    iK = np.linalg.inv(K_new)
    x = iK[0, 0] * u + iK[0, 1] * v + iK[0, 2]
    y = iK[1, 0] * u + iK[1, 1] * v + iK[1, 2]
    zw = iK[2, 0] * u + iK[2, 1] * v + iK[2, 2]
    x, y = x / zw, y / zw

    r2 = x * x + y * y
    radial = (1 + k1 * r2 + k2 * r2**2 + k3 * r2**3) / (1 + k4 * r2 + k5 * r2**2 + k6 * r2**3)
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y

    mapx = (K_orig[0, 0] * x_d + K_orig[0, 1] * y_d + K_orig[0, 2]).astype(np.float32)
    mapy = (K_orig[1, 0] * x_d + K_orig[1, 1] * y_d + K_orig[1, 2]).astype(np.float32)
    return mapx, mapy


class RemapCache:
    """Per-camera cached remap grids (host arrays, and tensors per
    device)."""

    def __init__(self):
        self._host = {}
        self._dev = {}

    def get(self, key, K_orig, d, K_new, out_size):
        if key not in self._host:
            self._host[key] = compute_remap(K_orig, d, K_new, out_size)
        return self._host[key]

    def get_scaled(self, key, K_orig, d, K_new, out_size, scale):
        """Remap grids rescaled into a `scale`-reduced source image (for
        cv2.IMREAD_REDUCED_COLOR_{scale} decodes).  Reduced pixel j covers
        source pixels [scale*j, scale*j+scale), center at scale*j +
        (scale-1)/2 — so source coordinate x lands at (x - (scale-1)/2)/scale
        in the reduced image."""
        if key not in self._host:
            mapx, mapy = compute_remap(K_orig, d, K_new, out_size)
            off = (scale - 1) / 2.0
            self._host[key] = (
                ((mapx - off) / scale).astype(np.float32),
                ((mapy - off) / scale).astype(np.float32),
            )
        return self._host[key]


    def get_device(self, key, K_orig, d, K_new, out_size, device):
        """(mapx, mapy) of get() as float32 tensors on `device`, uploaded
        once per (key, device)."""
        device = torch.device(device)
        if (key, device) not in self._dev:
            mapx, mapy = self.get(key, K_orig, d, K_new, out_size)
            self._dev[key, device] = (torch.from_numpy(mapx).to(device),
                                      torch.from_numpy(mapy).to(device))
        return self._dev[key, device]


def remap_host(image, mapx, mapy, interpolation=None):
    """cv2.remap with the cached grid (byte-exact to the reference) when cv2
    is installed, else the float bilinear fallback on CPU tensors (a host
    path, as the JAX package's fallback is)."""
    try:
        import cv2
    except ImportError:
        return remap_bilinear(torch.from_numpy(np.asarray(image)),
                              torch.from_numpy(np.asarray(mapx)),
                              torch.from_numpy(np.asarray(mapy))).numpy()
    interp = cv2.INTER_LINEAR if interpolation is None else interpolation
    return cv2.remap(image, mapx, mapy, interpolation=interp)


def remap_bilinear(image, mapx, mapy):
    """Bilinear remap with BORDER_CONSTANT = 0 (cv2.remap's default):
    four gathered taps, each zero off the image, weighted in the JAX
    function's order; integer images round half to even at the end.

    image [H, W, C] uint8 (or float); mapx / mapy [h, w] float32, on one
    device.  Returns [h, w, C] of the input dtype."""
    H, W = image.shape[0], image.shape[1]
    img = image.to(torch.float32)
    x0 = torch.floor(mapx)
    y0 = torch.floor(mapy)
    fx = mapx - x0
    fy = mapy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(inb[..., None], val, 0.0)

    out = (tap(y0i, x0i) * ((1 - fx) * (1 - fy))[..., None]
           + tap(y0i, x0i + 1) * (fx * (1 - fy))[..., None]
           + tap(y0i + 1, x0i) * ((1 - fx) * fy)[..., None]
           + tap(y0i + 1, x0i + 1) * (fx * fy)[..., None])
    if not image.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(image.dtype)
