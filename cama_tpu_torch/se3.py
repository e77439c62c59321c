"""SE(3) pose algebra on the host, NumPy float64 only.

Copies of the functions of cama_tpu/se3 (core.py, codec.py, trajectory.py)
that the overlay path reads: the clip reader's extrinsic chain, the scene's
pose chains, and the per-frame pose seek + SLERP.  cama_tpu.se3.core imports
jax whenever it is installed, so this package carries its own NumPy branch.
Every function does the same float64 operations in the same order as the
original and gives the same bits (tests/test_torch_host.py).

Quaternion convention: scalar-last (x, y, z, w), as in the TUM files.
"""
from __future__ import annotations

import numpy as np


def inv_se3(T):
    """Invert rigid transform(s) [..., 4, 4] without a general inverse."""
    T = np.asarray(T)
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    t = T[..., :3, 3:]
    top = np.concatenate([Rt, -(Rt @ t)], axis=-1)
    bottom_row = np.asarray([0.0, 0.0, 0.0, 1.0], dtype=T.dtype)
    bottom = np.broadcast_to(bottom_row, top.shape[:-2] + (1, 4))
    return np.concatenate([top, bottom], axis=-2)


def quat_normalize(q):
    q = np.asarray(q)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_conjugate(q):
    q = np.asarray(q)
    return np.concatenate([-q[..., :3], q[..., 3:]], axis=-1)


def quat_multiply(p, q):
    """Hamilton product in (x, y, z, w) convention: R(p*q) = R(p) @ R(q)."""
    p, q = np.asarray(p), np.asarray(q)
    px, py, pz, pw = (p[..., i] for i in range(4))
    qx, qy, qz, qw = (q[..., i] for i in range(4))
    return np.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        axis=-1,
    )


def quat_to_matrix(q):
    """(x, y, z, w) quaternion(s) -> rotation matrix [..., 3, 3] (normalizes)."""
    q = quat_normalize(np.asarray(q))
    x, y, z, w = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.stack(
        [
            np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(m):
    """Rotation matrix [..., 3, 3] -> (x, y, z, w) quaternion: Shepperd-style
    candidate selection by the largest of (m00, m11, m22, trace)."""
    m = np.asarray(m)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = np.stack([1 - tr + 2 * m00, m10 + m01, m20 + m02, m21 - m12], axis=-1)
    q1 = np.stack([m01 + m10, 1 - tr + 2 * m11, m21 + m12, m02 - m20], axis=-1)
    q2 = np.stack([m02 + m20, m12 + m21, 1 - tr + 2 * m22, m10 - m01], axis=-1)
    q3 = np.stack([m21 - m12, m02 - m20, m10 - m01, 1 + tr], axis=-1)
    cand = np.stack([q0, q1, q2, q3], axis=-2)  # [..., 4, 4]
    choice = np.argmax(np.stack([m00, m11, m22, tr], axis=-1), axis=-1)
    q = np.take_along_axis(cand, choice[..., None, None].astype(np.int64),
                           axis=-2)[..., 0, :]
    return quat_normalize(q)


def rotvec_to_quat(rv):
    """Axis-angle vector(s) [..., 3] -> quaternion (x, y, z, w)."""
    rv = np.asarray(rv)
    angle = np.linalg.norm(rv, axis=-1)
    half = 0.5 * angle
    small = angle < 1e-3
    scale_series = 0.5 - angle**2 / 48.0 + angle**4 / 3840.0
    safe_angle = np.where(small, np.ones_like(angle), angle)
    scale = np.where(small, scale_series, np.sin(half) / safe_angle)
    xyz = rv * scale[..., None]
    w = np.cos(half)[..., None]
    return np.concatenate([xyz, w], axis=-1)


def quat_to_rotvec(q):
    """Quaternion (x, y, z, w) -> axis-angle vector, angle in [0, pi]."""
    q = quat_normalize(np.asarray(q))
    q = np.where(q[..., 3:4] < 0, -q, q)  # w >= 0: the short way around
    norm_xyz = np.linalg.norm(q[..., :3], axis=-1)
    angle = 2.0 * np.arctan2(norm_xyz, q[..., 3])
    small = angle < 1e-3
    scale_series = 2.0 + angle**2 / 12.0 + 7.0 * angle**4 / 2880.0
    safe_sin = np.where(small, np.ones_like(angle), np.sin(angle / 2.0))
    scale = np.where(small, scale_series, angle / safe_sin)
    return q[..., :3] * scale[..., None]


def quat_slerp(q0, q1, t):
    """q(t) = q0 * exp(t * log(q0^-1 * q1)), the short path."""
    rv = quat_to_rotvec(quat_multiply(quat_conjugate(q0), q1))
    t = np.asarray(t)
    return quat_multiply(q0, rotvec_to_quat(rv * t[..., None]))


def slerp_transform(T0, T1, ratio):
    """Interpolate 4x4 transforms: the whole matrix is lerped elementwise and
    the rotation block is replaced by the slerped rotation."""
    T0, T1 = np.asarray(T0), np.asarray(T1)
    ratio = np.asarray(ratio)
    r = ratio[..., None, None]
    out = np.array(T0 * (1.0 - r) + T1 * r)
    q0 = matrix_to_quat(T0[..., :3, :3])
    q1 = matrix_to_quat(T1[..., :3, :3])
    out[..., :3, :3] = quat_to_matrix(quat_slerp(q0, q1, ratio))
    return out


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


def seek_indices(timestamps, queries, t_max_diff, interpolate=False):
    """Host float64 index/ratio computation for a batch of pose seeks:
    exact-match shortcut (|q - ts| <= 1e-9 + 1e-20*|q|, first match wins),
    then bracketing indices + SLERP ratio (interpolate) or the nearer pose,
    each invalid past t_max_diff.  Returns dict of [M] arrays: il, ir,
    ratio, valid."""
    ts = np.asarray(timestamps, dtype=np.float64).reshape(-1)
    q = np.asarray(queries, dtype=np.float64).reshape(-1)
    n = ts.shape[0]

    right = np.searchsorted(ts, q, side="left")
    left = right - 1
    il = np.clip(left, 0, n - 1)
    ir = np.clip(right, 0, n - 1)

    tol = 1e-9 + 1e-20 * np.abs(q)
    first = np.searchsorted(ts, q - tol, side="left")
    i_exact = np.clip(first, 0, n - 1)
    exact = (first < n) & (np.abs(ts[i_exact] - q) <= tol)

    if interpolate:
        # q in [ts[0] - 1e-9, ts[0]) snaps to the first segment
        snap_front = (right == 0) & (q - ts[0] > -1e-9) & (q - ts[0] < 0)
        left = np.where(snap_front, 0, left)
        right = np.where(snap_front, 1, right)
        in_range = (right < n) & (left >= 0)
        il2 = np.clip(left, 0, n - 1)
        ir2 = np.clip(right, 0, n - 1)
        gap = ts[ir2] - ts[il2]
        ok = in_range & (gap <= t_max_diff) & (gap > 0)
        safe_gap = np.where(gap > 0, gap, 1.0)
        ratio = (q - ts[il2]) / safe_gap
        out_il, out_ir = il2, ir2
    else:
        ldiff = np.where(left >= 0, q - ts[il], np.inf)
        rdiff = np.where(right < n, ts[ir] - q, np.inf)
        ok = np.minimum(ldiff, rdiff) <= t_max_diff
        pick = np.where(ldiff < rdiff, il, ir)
        out_il = out_ir = pick
        ratio = np.zeros_like(q)

    out_il = np.where(exact, i_exact, out_il)
    out_ir = np.where(exact, i_exact, out_ir)
    ratio = np.where(exact, 0.0, ratio)
    valid = ok | exact
    ratio = np.where(valid, ratio, 0.0)
    return {"il": out_il, "ir": out_ir, "ratio": ratio, "valid": valid}


def apply_seek(transforms, idx):
    """Gather + SLERP the seek computed by `seek_indices`; invalid rows come
    back as identity."""
    T = np.asarray(transforms)
    il, ir = np.asarray(idx["il"]), np.asarray(idx["ir"])
    ratio = np.asarray(idx["ratio"]).astype(T.dtype)
    valid = np.asarray(idx["valid"])
    interp = slerp_transform(T[il], T[ir], ratio)
    out = np.where((il == ir)[:, None, None], T[il], interp)
    return np.where(valid[:, None, None], out, np.eye(4, dtype=T.dtype))


class Trajectory:
    """Absolute poses [N, 4, 4] float64 with timestamps [N, 1]: the part of
    cama_tpu.se3.trajectory.Trajectory that scene compilation and the frame
    matrices read."""

    def __init__(self):
        self._abs = np.zeros((0, 4, 4))
        self.timestamps = np.zeros((0, 1))

    def loadarray(self, array):
        """Load TUM rows [t x y z qx qy qz qw]."""
        T, ts = tum_to_transforms(array)
        self._abs, self.timestamps = T, ts[:, None]

    def from_absolute_transform(self, T):
        T = np.asarray(T, dtype=np.float64)
        assert T.shape[-2:] == (4, 4)
        self._abs = T

    def as_transform(self, absolute=True):
        if not absolute:
            raise NotImplementedError("only absolute poses are kept")
        return np.asarray(self._abs)

    def normalize2center(self):
        self._abs = inv_se3(self._abs[len(self._abs) // 2]) @ self._abs

    def right_rotate(self, extrinsic):
        assert extrinsic.shape == (4, 4)
        self._abs = self._abs @ np.asarray(extrinsic)
