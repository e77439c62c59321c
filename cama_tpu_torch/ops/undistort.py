"""Undistortion + resize remap grids, computed once per camera (host).

Copy of the host half of cama_tpu/ops/undistort.py, which cannot be
imported without jax.  `compute_remap` replicates OpenCV's
initUndistortRectifyMap math (pinhole + radial k1..k6 / tangential p1 p2,
identity rectification); `remap_host` applies the grid with cv2.remap, so
base images are byte-exact to the reference renderer.  The device bilinear
remap is not part of this package yet.
"""
from __future__ import annotations

import numpy as np


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
    """Per-camera cached host remap grids."""

    def __init__(self):
        self._host = {}

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


def remap_host(image, mapx, mapy, interpolation=None):
    """cv2.remap with the cached grid (byte-exact to the reference)."""
    import cv2

    interp = cv2.INTER_LINEAR if interpolation is None else interpolation
    return cv2.remap(image, mapx, mapy, interpolation=interp)
