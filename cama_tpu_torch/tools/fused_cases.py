"""Inputs that exercise the edges of the fused kernel
(ops/fused_compact.py, csrc/fused_compact.cu), as numpy arrays from a seed.

Each case is (points, valid, cls, A, B, frame_valid, width, height,
crop_lo, crop_hi).  The geometry is exactly representable in float32
(identity rotations, quarter-pixel positions, unit depth), so every
implementation of the projection keeps the same points and the kernel, its
plain version and the JAX package's kernel must agree bit for bit.
chip_smoke.py holds the kernel against its plain version on them; the tests
hold the plain version against the JAX package's kernel.
"""
from __future__ import annotations

import numpy as np

W = H = 64  # image size of every case


def _identity_frames(F, cams=1):
    A = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    B = np.zeros((F, cams, 3, 4), np.float32)
    B[:, :, 0, 0] = B[:, :, 1, 1] = B[:, :, 2, 2] = 1.0
    return A, B


def tile_boundary_case(P, seed=3):
    """Same-pixel runs (a new pixel every 3 points) across every group,
    warp and tile boundary, invalid points inside runs, one frame and one
    camera, identity geometry, no crop."""
    rng = np.random.default_rng(seed)
    A, B = _identity_frames(1)
    base = np.repeat(np.arange(P // 3 + 2), 3)[:P]
    pts = np.stack([(base % W).astype(np.float32),
                    ((base // W) % H).astype(np.float32),
                    np.ones(P, np.float32)], axis=1)
    valid = np.ones(P, bool)
    valid[rng.choice(P, min(200, P // 4), replace=False)] = False
    cls = (base % 3).astype(np.int32)
    return (pts, valid, cls, A, B, np.ones(1, bool), W, H,
            np.full(3, -1e6, np.float32), np.full(3, 1e6, np.float32))


def crop_straddle_case(F, groups=1000, seed=5):
    """P = 31 * groups + 5 points over F frames and two cameras:

    - runs of 3 points share a pixel (x = n + 0.25, n + 0.5, n + 0.75) and
      the crop's x edges (3.5 and 40.5, shifted by 0.125 per frame) cut
      some runs in two;
    - every third stretch of 80 points lies outside the crop in y, so whole
      32-point groups are culled next to kept ones;
    - every seventh stretch lies behind the cameras (z = -1), 5 % of the
      points are invalid, and frame 5 (when F > 5) is invalid;
    - camera 1 sees the scene shifted by 0.25 px, so the cameras keep
      different pixels of the same points."""
    rng = np.random.default_rng(seed)
    P = 31 * groups + 5
    i = np.arange(P)
    run = i // 3
    stretch = i // 80
    x = 2.0 + (run % 45) + np.asarray([0.25, 0.5, 0.75])[i % 3]
    y = np.where(stretch % 3 == 2, 50.5, (run // 45) % 28 + 0.5)
    z = np.where(stretch % 7 == 5, -1.0, 1.0)
    pts = np.stack([x, y, z], axis=1).astype(np.float32)
    valid = rng.random(P) >= 0.05
    cls = (run % 3).astype(np.int32)
    A, B = _identity_frames(F, cams=2)
    A[:, 0, 3] = -0.125 * np.arange(F)
    B[:, 1, 0, 3] = 0.25
    fv = np.ones(F, bool)
    if F > 5:
        fv[5] = False
    lo = np.asarray([3.5, -1.0, -200.0], np.float32)
    hi = np.asarray([40.5, 30.0, 200.0], np.float32)
    return pts, valid, cls, A, B, fv, W, H, lo, hi
