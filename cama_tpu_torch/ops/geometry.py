"""Per-frame matrix composition on the host (float64), and the device
projection of points into every frame and camera (float32).

The host half copies cama_tpu/ops/geometry.py's, which cannot be imported
without jax; the pose seek comes from cama_tpu_torch.se3.  Pose chains stay
in float64 on the host; only the composed matrices are cast to float32 for
the device.  Bit-identical to the JAX package's functions
(tests/test_torch_pipeline.py).

`project_frames` is the counterpart of the JAX einsum projection.  Every
device lane of this package projects with the same elementwise order,
((m0*x + m1*y) + m2*z) + m3 with IEEE division, so the CUDA kernels
(csrc/project.cuh) and their plain versions keep the same points bit for
bit on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cama_tpu_torch.ops.lift import CROP_BOX
from cama_tpu_torch.ops.raster import compact_rows
from cama_tpu_torch.se3 import apply_seek, seek_indices

MAX_CAM = 8  # cameras per frame the projection kernels hold on chip


@dataclass
class FrameMatrices:
    """Host-composed per-frame matrices feeding the device pipeline."""

    A: np.ndarray  # [F, 4, 4] world -> chassis (crop frame)
    B: np.ndarray  # [F, C, 3, 4] world -> scaled pixel (pre-division)
    frame_valid: np.ndarray  # [F] bool (pose seek succeeded)
    frame_indices: np.ndarray  # [F] int (image index in the sync table)
    chassis2world_f32: np.ndarray  # [F, 4, 4] float32 (reference-parity cast)


def compose_frame_matrices(
    trajectory,
    frame_times,
    chassis2cam,
    K_scaled,
    t_max_diff=0.5,
    start_index=1,
):
    """Seek chassis2world at each frame time and build A/B (host, float64).

    The reference chain: seek + SLERP, cast to float32, invert, then fold the
    static chassis->camera extrinsic and the scaled K into one 3x4 per
    camera.  Frames before `start_index` are skipped like the reference.

    Args:
        trajectory: se3.Trajectory holding chassis2world poses
        frame_times: [Nall] seconds (sync table of the main camera)
        chassis2cam: [C, 4, 4] float64
        K_scaled:    [C, 3, 3] float64 (already rescaled to output size)
    """
    frame_times = np.asarray(frame_times, dtype=np.float64)[start_index:]
    frame_indices = np.arange(len(frame_times)) + start_index
    T_all = trajectory.as_transform(True)
    ts = trajectory.timestamps[:, 0]
    idx = seek_indices(ts, frame_times, t_max_diff, interpolate=True)
    c2w = apply_seek(T_all, idx).astype(np.float32)  # reference casts to f32
    valid = idx["valid"]

    # world->chassis: the reference inverts the float32 matrix; replicate
    # that bit pattern, then promote
    with np.errstate(all="ignore"):
        w2c_f32 = np.linalg.inv(np.where(valid[:, None, None], c2w,
                                         np.eye(4, dtype=np.float32)))
    A = w2c_f32.astype(np.float64)

    chassis2cam = np.asarray(chassis2cam, dtype=np.float64)
    K_scaled = np.asarray(K_scaled, dtype=np.float64)
    # K_tilde [C, 3, 4]: pinhole projection of homogeneous camera-frame points
    K_tilde = np.concatenate([K_scaled, np.zeros((len(K_scaled), 3, 1))], axis=-1)
    # B[f, c] = K_tilde[c] @ chassis2cam[c] @ A[f]
    B = np.einsum("cij,cjk,fkl->fcil", K_tilde, chassis2cam, A)
    return FrameMatrices(
        A=A,
        B=B,
        frame_valid=valid,
        frame_indices=frame_indices,
        chassis2world_f32=c2w,
    )


def crop_bounds(crop=None):
    """(lo, hi) float32 [3] corners of the chassis-frame crop box."""
    crop = crop or CROP_BOX
    lo = np.array([crop["x_min"], crop["y_min"], crop["z_min"]], dtype=np.float32)
    hi = np.array([crop["x_max"], crop["y_max"], crop["z_max"]], dtype=np.float32)
    return lo, hi


def _row(m, x, y, z):
    """((m0*x + m1*y) + m2*z) + m3 over the last axis of m [..., 4], broadcast
    against the point coordinates [P] -> [..., P]."""
    return ((m[..., 0, None] * x + m[..., 1, None] * y)
            + m[..., 2, None] * z) + m[..., 3, None]


def project_frames(points, valid, A, B, frame_valid, width, height, crop_lo,
                   crop_hi):
    """Project all points into all frames x cameras (plain PyTorch, any
    device).

    Args:
        points [P, 3] f32, valid [P] bool
        A [F, 4, 4] f32 world -> chassis, B [F, C, 3, 4] f32 world -> pixel
        frame_valid [F] bool
        width/height: output image size; crop_lo/crop_hi: [3] chassis box
            (inclusive)
    Returns:
        vu [F, C, P, 2] f32 (v, u) and keep [F, C, P] bool — crop & z > 0 &
        in-bounds & valid & frame_valid.
    """
    ok = crop_mask(points, valid, A, frame_valid, crop_lo, crop_hi)
    vu, keep = _camera_pixels(B, points[:, 0], points[:, 1], points[:, 2],
                              width, height)
    return vu, keep & ok[:, None, :]


def crop_mask(points, valid, A, frame_valid, crop_lo, crop_hi):
    """[F, P] bool: the valid points of the valid frames inside the
    inclusive chassis crop box, with project_frames' elementwise order."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    ok = valid[None, :] & frame_valid[:, None]
    for r in range(3):
        cr = _row(A[:, r], x, y, z)
        ok = ok & (cr >= float(crop_lo[r])) & (cr <= float(crop_hi[r]))
    return ok


def _camera_pixels(B, x, y, z, width, height):
    """(vu [F, C, N, 2], keep [F, C, N]: z > 0 and in the image) of points
    x, y, z (each [N], or [F, 1, N]) under B [F, C, 3, 4]."""
    px = _row(B[:, :, 0], x, y, z)
    py = _row(B[:, :, 1], x, y, z)
    pz = _row(B[:, :, 2], x, y, z)
    mask_z = pz > 0
    safe_z = torch.where(mask_z, pz, torch.ones_like(pz))
    u = px / safe_z
    v = py / safe_z
    keep = mask_z & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return torch.stack([v, u], dim=-1), keep


def crop_compact_project_idx(points, valid, A, B, frame_valid, width, height,
                             crop_lo, crop_hi, k1):
    """Two-stage stages 1 and 2 for a chunk of frames: the camera-
    independent crop test, a stable compaction of its survivors to k1
    slots per frame, then the camera projection of those survivors only.
    Counterpart of cama_tpu/ops/geometry.py:crop_compact_project_idx (one
    frame there, F here), with project_frames' elementwise order, so a
    survivor keeps exactly the pixel and keep bits project_frames gives it.

    Returns (vu [F, C, k1, 2], keep [F, C, k1], idx [F, k1] int64 point
    indices in original order; padding slots carry index 0 with keep
    False, and survivors past k1 are dropped) and the crop count [F]
    int32, which callers hold against k1."""
    sel = crop_mask(points, valid, A, frame_valid, crop_lo, crop_hi)
    P = points.shape[0]
    order = torch.arange(P, dtype=torch.int32, device=points.device)
    idx = compact_rows(order.expand(sel.shape[0], P), sel, k1)
    sel_valid = idx >= 0
    idx = torch.where(sel_valid, idx, 0).to(torch.int64)
    pts = points[idx]                                      # [F, k1, 3]
    vu, keep = _camera_pixels(B, pts[:, None, :, 0], pts[:, None, :, 1],
                              pts[:, None, :, 2], width, height)
    return (vu, keep & sel_valid[:, None, :], idx,
            sel.sum(dim=-1, dtype=torch.int32))


def crop_compact_project(points, valid, cls, A, B, frame_valid, width, height,
                         crop_lo, crop_hi, k1):
    """crop_compact_project_idx with the class ids gathered through the
    selection: (vu [F, C, k1, 2], keep [F, C, k1], cls_sel [F, k1], crop
    count [F])."""
    vu, keep, idx, n_crop = crop_compact_project_idx(
        points, valid, A, B, frame_valid, width, height, crop_lo, crop_hi, k1)
    return vu, keep, cls[idx], n_crop


def check_frame_inputs(points, valid, A, B, frame_valid, cls=None):
    """Validate a kernel's projection inputs: dtypes, shapes, one device and
    1..MAX_CAM cameras.  Returns (P, F, C)."""
    P = points.shape[0]
    F, C = B.shape[0], B.shape[1]
    if not 1 <= C <= MAX_CAM:
        raise ValueError(f"the projection kernels support 1..{MAX_CAM} "
                         f"cameras, got {C}")
    if P < 1:
        raise ValueError("the projection kernels need at least one point")
    expect = {"points": (points, (P, 3), torch.float32),
              "valid": (valid, (P,), torch.bool),
              "A": (A, (F, 4, 4), torch.float32),
              "B": (B, (F, C, 3, 4), torch.float32),
              "frame_valid": (frame_valid, (F,), torch.bool)}
    if cls is not None:
        expect["cls"] = (cls, (P,), torch.int32)
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on {points.device}")
    return P, F, C


def route(t, kernel):
    """'cuda' for a CUDA tensor (launch the kernel), 'cpu' for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no {kernel} implementation for {t.device}")
