"""Trajectory file codecs: TUM / KITTI / ASL (EuRoC) <-> batched 4x4
arrays, host float64.  A copy of cama_tpu/se3/codec.py (same bits,
tests/test_torch_se3_pose.py)."""
from __future__ import annotations

import numpy as np

from cama_tpu_torch.se3.core import matrix_to_quat, quat_to_matrix


def tum_to_transforms(array):
    """TUM rows [t x y z qx qy qz qw] -> (T [N, 4, 4] float64, timestamps [N])."""
    array = np.asarray(array, dtype=np.float64)
    if array.ndim == 1:
        array = array[None]
    assert array.shape[1] == 8, f"TUM rows need 8 columns, got {array.shape[1]}"
    T = np.zeros((array.shape[0], 4, 4), dtype=np.float64)
    T[:, 3, 3] = 1.0
    T[:, :3, :3] = quat_to_matrix(array[:, 4:8])
    T[:, :3, 3] = array[:, 1:4]
    return T, array[:, 0].copy()


def transforms_to_tum(T, timestamps):
    """(T [N, 4, 4], timestamps [N]) -> TUM rows [N, 8]."""
    T = np.asarray(T, dtype=np.float64)
    timestamps = np.asarray(timestamps, dtype=np.float64).reshape(-1)
    assert T.shape[0] == timestamps.shape[0]
    quat = matrix_to_quat(T[:, :3, :3])
    return np.concatenate([timestamps[:, None], T[:, :3, 3], quat], axis=1)


def kitti_to_transforms(array):
    """KITTI rows (12 columns, row-major 3x4) -> (T [N, 4, 4], None)."""
    array = np.asarray(array, dtype=np.float64)
    assert array.shape[1] == 12
    T = np.zeros((array.shape[0], 4, 4), dtype=np.float64)
    T[:, :3, :4] = array.reshape(-1, 3, 4)
    T[:, 3, 3] = 1.0
    return T, None


def asl_to_transforms(array):
    """ASL/EuRoC rows (17 columns: ts [ns], xyz, q wxyz, ...) ->
    (T [N, 4, 4], timestamps [N] in seconds)."""
    array = np.asarray(array, dtype=np.float64)
    assert array.shape[1] == 17
    T = np.zeros((array.shape[0], 4, 4), dtype=np.float64)
    T[:, 3, 3] = 1.0
    T[:, :3, :3] = quat_to_matrix(array[:, [5, 6, 7, 4]])
    T[:, :3, 3] = array[:, 1:4]
    return T, array[:, 0] * 1e-9


_LOADERS = {"tum": tum_to_transforms, "kitti": kitti_to_transforms,
            "asl": asl_to_transforms}


def load_trajectory_txt(path, style="tum"):
    """np.loadtxt and decode: (T [N, 4, 4], timestamps or None)."""
    if style not in _LOADERS:
        raise NotImplementedError(
            f"style {style} not supported; choose from {sorted(_LOADERS)}")
    return _LOADERS[style](np.loadtxt(path))
