"""Per-frame matrix composition on the host (float64).

Copies of cama_tpu/ops/geometry.py's host half, which cannot be imported
without jax; the pose seek comes from cama_tpu_torch.se3.  Pose chains stay in float64 on the host; only the composed
matrices are cast to float32 for the device.  Bit-identical to the JAX
package's functions (tests/test_torch_pipeline.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cama_tpu.ops.lift import CROP_BOX
from cama_tpu_torch.se3 import apply_seek, seek_indices


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
