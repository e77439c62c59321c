"""Batched SE(3) / SO(3) algebra on the host, NumPy float64.

Copies of cama_tpu/se3/core.py's NumPy branch: every function does the same
float64 operations in the same order as the original and gives the same
bits (tests/test_torch_host.py, tests/test_torch_se3_pose.py).
cama_tpu.se3.core imports jax whenever it is installed, so this package
carries its own copy.  `rel_to_abs` also takes a torch tensor, and then
composes on the tensor's device.

Quaternion convention: scalar-last (x, y, z, w), as in the TUM files.
"""
from __future__ import annotations

import numpy as np
import torch


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


_AXES = {"x": 0, "y": 1, "z": 2}


def _single_axis_quat(axis, angle):
    zeros = np.zeros_like(angle)
    half = angle / 2.0
    comps = [zeros, zeros, zeros, np.cos(half)]
    comps[axis] = np.sin(half)
    return np.stack(comps, axis=-1)


def from_euler(seq, angles, degrees=False):
    """Euler angles -> quaternion (x, y, z, w), scipy-compatible.
    Uppercase seq = intrinsic (rotating frame), lowercase = extrinsic."""
    angles = np.asarray(angles)
    squeeze = angles.ndim == 1
    angles_b = angles[None, :] if squeeze else angles
    if degrees:
        angles_b = angles_b * (np.pi / 180.0)
    axes = [_AXES[c] for c in seq.lower()]
    qs = [_single_axis_quat(ax, angles_b[..., i]) for i, ax in enumerate(axes)]
    if seq == seq.upper():
        q = quat_multiply(quat_multiply(qs[0], qs[1]), qs[2])
    else:
        q = quat_multiply(quat_multiply(qs[2], qs[1]), qs[0])
    return q[0] if squeeze else q


def as_euler(m, seq, degrees=False):
    """Rotation matrix [..., 3, 3] -> Euler angles for any 3-char seq
    (uppercase = intrinsic, lowercase = extrinsic), through the duality
    intrinsic(abc) == reversed(extrinsic(cba)).  At gimbal lock the third
    angle is set to 0, as scipy does."""
    m = np.asarray(m)
    intrinsic = seq == seq.upper()
    s = seq.lower()
    if not intrinsic:
        s = s[::-1]
    i, j, k3 = _AXES[s[0]], _AXES[s[1]], _AXES[s[2]]
    eps = 1.0 if (j - i) % 3 == 1 else -1.0
    if s[0] == s[2]:  # proper Euler angles
        k = 3 - i - j  # the unused axis
        beta = np.arccos(np.clip(m[..., i, i], -1.0, 1.0))
        safe = np.abs(np.abs(m[..., i, i]) - 1.0) > 1e-7
        alpha = np.arctan2(m[..., j, i], -eps * m[..., k, i])
        gamma = np.arctan2(m[..., i, j], eps * m[..., i, k])
        lock_alpha = np.arctan2(eps * m[..., k, j], m[..., j, j])
    else:  # Tait-Bryan angles
        k = k3
        sy = eps * m[..., i, k]
        beta = np.arctan2(sy, np.sqrt(np.clip(m[..., i, i] ** 2 + m[..., i, j] ** 2,
                                              0.0, None)))
        safe = np.abs(np.abs(sy) - 1.0) > 1e-7
        alpha = np.arctan2(-eps * m[..., j, k], m[..., k, k])
        gamma = np.arctan2(-eps * m[..., i, j], m[..., i, i])
        # at the lock the alpha/gamma coupling flips sign with the pole
        lock_alpha = np.arctan2(np.sign(sy) * m[..., j, i], m[..., j, j])
    alpha = np.where(safe, alpha, lock_alpha)
    gamma = np.where(safe, gamma, np.zeros_like(gamma))
    out = np.stack([alpha, beta, gamma], axis=-1)
    if not intrinsic:
        out = out[..., ::-1]
    if degrees:
        out = out * (180.0 / np.pi)
    return out


def rel_to_abs(rel):
    """Cumulative compose: abs[0] = I, abs[n] = rel[0] @ ... @ rel[n-1];
    [N, 4, 4] -> [N + 1, 4, 4].  A NumPy array composes in a host loop, as
    the original's NumPy branch does; a torch tensor composes on its device
    as a prefix product in log2(N) rounds of one batched matmul each (the
    original's associative scan on device arrays: the same products,
    associated differently, so equal within float rounding)."""
    if isinstance(rel, torch.Tensor):
        prefix, d = rel, 1
        while d < len(prefix):
            prefix = torch.cat([prefix[:d], prefix[:-d] @ prefix[d:]])
            d *= 2
        eye = torch.eye(4, dtype=rel.dtype, device=rel.device)
        return torch.cat([eye[None], prefix])
    rel = np.asarray(rel)
    out = [np.eye(4, dtype=rel.dtype)]
    for T in rel:
        out.append(out[-1] @ T)
    return np.stack(out)


def abs_to_rel(abs_T):
    """rel[i] = inv(abs[i+1]) @ abs[i]; [N, 4, 4] -> [N - 1, 4, 4]."""
    abs_T = np.asarray(abs_T)
    return inv_se3(abs_T[1:]) @ abs_T[:-1]
