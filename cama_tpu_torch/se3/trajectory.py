"""Trajectory: the pose-sequence container (absolute poses [N, 4, 4]
float64, timestamps [N, 1]) and the batched pose seek: host index pass,
then gather + SLERP.  A copy of cama_tpu/se3/trajectory.py on NumPy
float64, the same bits as the original (tests/test_torch_host.py,
tests/test_torch_se3_pose.py).
"""
from __future__ import annotations

import numpy as np

from cama_tpu_torch.se3 import codec
from cama_tpu_torch.se3.core import (
    abs_to_rel,
    as_euler,
    from_euler,
    inv_se3,
    matrix_to_quat,
    quat_to_matrix,
    quat_to_rotvec,
    rel_to_abs,
    rotvec_to_quat,
    slerp_transform,
)


def seek_indices(timestamps, queries, t_max_diff, interpolate=False):
    """Host-side (float64) index/ratio computation for a batch of pose seeks.

    Replicates reference seek_by_timestamp semantics
    (cama/pose_transformer.py:589-652) including:
      * exact-match shortcut with |q - ts| <= 1e-9 + 1e-20*|q|
      * interpolate mode: bracketing indices + SLERP ratio, invalid when the
        query is out of range or the bracketing gap exceeds t_max_diff
      * nearest mode: closer bracketing pose, invalid when the closer gap
        exceeds t_max_diff

    Timestamp comparisons need float64: 1e-9 s tolerances on unix-epoch
    values are below float32 resolution.

    Returns dict of [M] arrays: il, ir (gather indices), ratio (0 for
    non-interpolating picks), valid.
    """
    ts = np.asarray(timestamps, dtype=np.float64).reshape(-1)
    q = np.asarray(queries, dtype=np.float64).reshape(-1)
    n = ts.shape[0]

    right = np.searchsorted(ts, q, side="left")
    left = right - 1
    il = np.clip(left, 0, n - 1)
    ir = np.clip(right, 0, n - 1)

    # exact-match shortcut: matches form a contiguous run in sorted ts, and
    # the reference takes the FIRST matching index (np.where(...)[0][0]), so
    # find the first stamp >= q - tol and test it
    tol = 1e-9 + 1e-20 * np.abs(q)
    first = np.searchsorted(ts, q - tol, side="left")
    i_exact = np.clip(first, 0, n - 1)
    exact = (first < n) & (np.abs(ts[i_exact] - q) <= tol)

    if interpolate:
        # tolerate q in [ts[0] - 1e-9, ts[0]) by snapping to the first segment
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

    # fold the exact shortcut in: ratio 0 and both indices at the exact pose
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
    # il == ir takes T[il] itself: a SLERP at ratio 0 would requantize the
    # rotation
    interp = slerp_transform(T[il], T[ir], ratio)
    out = np.where((il == ir)[:, None, None], T[il], interp)
    return np.where(valid[:, None, None], out, np.eye(4, dtype=T.dtype))


def seek_by_timestamps(timestamps, transforms, queries, t_max_diff, interpolate=False):
    """Pose seek for a batch of query times: (out [M, 4, 4], valid [M] bool),
    invalid rows identity (see `seek_indices`).  Instead of raising per
    frame, the validity mask lets the caller drop frames."""
    idx = seek_indices(np.asarray(timestamps), np.asarray(queries), t_max_diff, interpolate)
    return apply_seek(transforms, idx), np.asarray(idx["valid"])


class Trajectory:
    """Pose-sequence container with the reference PoseTransformer's surface.

    State: absolute transforms [N, 4, 4] float64 + timestamps [N] (host NumPy).
    Relative transforms follow the reference's (unusual) convention
    rel[i] = inv(abs[i+1]) @ abs[i] (cama/pose_transformer.py:183-196).
    """

    def __init__(self, euler_order="ZXY", degree=False):
        self.euler_order = euler_order
        self.degree = degree
        self.reset()

    def reset(self):
        self._abs = None  # [N, 4, 4] or None
        self._rel = None  # [N-1, 4, 4] or None
        self._rel_rot = None  # [M, 3, 3] pieces (pre-composition), ref parity
        self._rel_trans = None  # [M, 3]
        self.timestamps = np.zeros((0, 1))

    # ---------------- loading ----------------

    def loadarray(self, array, style="tum"):
        self.reset()
        if style == "tum":
            T, ts = codec.tum_to_transforms(array)
            self.timestamps = ts[:, None]
        elif style == "kitti":
            T, _ = codec.kitti_to_transforms(array)
        elif style == "asl":
            T, ts = codec.asl_to_transforms(array)
            self.timestamps = ts[:, None]
        else:
            raise NotImplementedError(
                f"style {style} not supported yet. Currently support [tum, kitti, asl]"
            )
        self._abs = T
        self._rel = abs_to_rel(T) if T.shape[0] > 1 else np.zeros((0, 4, 4))

    def load_timestamp(self, timestamps, style="unix", relative=True):
        if style == "kitti":
            from datetime import datetime

            timestamps = [
                datetime.strptime(t[:-4], "%Y-%m-%d %H:%M:%S.%f").timestamp() for t in timestamps
            ]
            style = "unix"
        if style != "unix":
            raise NotImplementedError(f"style {style} not supported yet")
        ts = np.asarray(timestamps, dtype=np.float64)
        if ts.ndim == 1:
            ts = ts[:, None]
        elif ts.ndim != 2:
            raise RuntimeError(f"input timestamp shape {ts.shape} incorrect!")
        self.timestamps = ts

    def from_absolute_transform(self, T):
        T = np.asarray(T, dtype=np.float64)
        assert T.shape[-2:] == (4, 4)
        self._abs = T
        self._rel = abs_to_rel(T) if T.shape[0] > 1 else np.zeros((0, 4, 4))

    def from_relative_transform(self, T):
        T = np.asarray(T, dtype=np.float64)
        assert T.shape[-2:] == (4, 4)
        self._rel = T
        self._abs = None

    def from_relative_quaternion(self, quaternions):
        q = np.asarray(quaternions, dtype=np.float64)
        assert q.ndim == 2 and q.shape[1] == 4
        self._rel_rot = quat_to_matrix(q)
        self._abs = None

    def from_relative_eulers(self, eulers):
        e = np.asarray(eulers, dtype=np.float64)
        self._rel_rot = quat_to_matrix(from_euler(self.euler_order, e, degrees=self.degree))
        self._abs = None

    def from_axis_angle(self, axis_angles, absolute):
        aa = np.asarray(axis_angles, dtype=np.float64)
        assert aa.ndim == 2 and aa.shape[1] == 3
        rot = quat_to_matrix(rotvec_to_quat(aa))
        if absolute:
            if self._abs is None or len(self._abs) == 0:
                self._abs = np.tile(np.eye(4), (aa.shape[0], 1, 1))
            assert len(self._abs) == aa.shape[0]
            self._abs[:, :3, :3] = rot
        else:
            self._rel_rot = rot
            self._abs = None

    def from_translation(self, translations, absolute):
        t = np.asarray(translations, dtype=np.float64)
        assert t.ndim == 2 and t.shape[1] == 3
        if absolute:
            if self._abs is None or len(self._abs) == 0:
                self._abs = np.tile(np.eye(4), (t.shape[0], 1, 1))
            assert len(self._abs) == t.shape[0]
            self._abs[:, :3, 3] = t
        else:
            self._rel_trans = t
            self._abs = None

    # ---------------- conversions ----------------

    def _compose_rel_parts(self):
        """Reference quirk parity: relative (rot, trans) pieces are composed
        into a matrix and then INVERTED (cama/pose_transformer.py:174-181)."""
        assert self._rel_rot is not None and self._rel_trans is not None
        assert len(self._rel_rot) == len(self._rel_trans)
        T = np.tile(np.eye(4), (len(self._rel_rot), 1, 1))
        T[:, :3, :3] = self._rel_rot
        T[:, :3, 3] = self._rel_trans
        self._rel = inv_se3(T)

    def _ensure_abs(self):
        if self._abs is None or (hasattr(self._abs, "__len__") and len(self._abs) == 0):
            if self._rel is None:
                if self._rel_rot is None or self._rel_trans is None:
                    raise RuntimeError("please load data first!")
                self._compose_rel_parts()
            if self._rel is None or len(self._rel) == 0:
                raise RuntimeError("please load data first!")
            self._abs = rel_to_abs(self._rel)
        return self._abs

    def _ensure_rel(self):
        if self._rel is None:
            if self._rel_rot is not None and self._rel_trans is not None:
                self._compose_rel_parts()
            elif self._abs is not None:
                if len(self._abs) == 0:
                    raise RuntimeError("please load absolute first, by using loadtxt()")
                self._rel = abs_to_rel(self._abs)
            else:
                raise RuntimeError("please load data first!")
        return self._rel

    def as_transform(self, absolute=True):
        if absolute:
            return np.asarray(self._ensure_abs())
        return np.asarray(self._ensure_rel())

    def as_quaternions(self, absolute=True):
        if not absolute:
            raise NotImplementedError("sorry, not yet supported :-(")
        return matrix_to_quat(self._ensure_abs()[:, :3, :3])

    def as_euler(self, absolute):
        T = self._ensure_abs() if absolute else self._ensure_rel()
        return as_euler(T[:, :3, :3], self.euler_order, degrees=self.degree)

    def as_axis_angle(self, absolute):
        T = self._ensure_abs() if absolute else self._ensure_rel()
        return quat_to_rotvec(matrix_to_quat(T[:, :3, :3]))

    def as_translations(self, absolute):
        T = self._ensure_abs() if absolute else self._ensure_rel()
        return T[:, :3, 3].copy()

    def as_trans_quat(self, absolute=True):
        return np.concatenate(
            [self.as_translations(absolute), self.as_quaternions(absolute)], axis=1
        )

    def dumparray(self, style="tum"):
        if style != "tum":
            raise NotImplementedError(f"style {style} not supported yet.\nCurrently support [tum]")
        T = self._ensure_abs()
        ts = self.timestamps
        if ts.shape[0] == 0:
            raise RuntimeError("No timestamps found, pleas load timestamps first")
        if ts.shape[0] + 1 == len(T):
            # timestamps correspond to transforms[1:] (reference convention,
            # cama/pose_transformer.py:348-350)
            T = T[1:]
            self._abs = T
        elif ts.shape[0] != len(T):
            raise RuntimeError(
                f"num of timestamps = {ts.shape[0]} while num of absolute transform = {len(T)}"
            )
        return np.concatenate([ts, self.as_trans_quat(absolute=True)], axis=1)

    # ---------------- in-place transforms ----------------

    def get_timestamps(self):
        if len(self.timestamps) == 0:
            raise RuntimeError("please load timestamps first, from loadtxt()")
        return self.timestamps

    def as_axisangle(self, absolute):
        from warnings import warn

        warn("Warning(Deprecation): as_axisangle is renamed to as_axis_angle, "
             "please consider update")
        return self.as_axis_angle(absolute=absolute)

    def rotate(self, extrinsic):
        """Deprecated right-multiply (reference parity,
        cama/pose_transformer.py:471-499)."""
        from warnings import warn

        warn("Warning(Deprecation): rotate function may lead misunderstanding\n"
             "Please consider using transform()")
        self.right_rotate(extrinsic)

    def _set_abs(self, T):
        """Install new absolute poses and invalidate the relative cache —
        in-place pose ops would otherwise serve stale pre-transform relative
        frames from _rel."""
        self._abs = T
        self._rel = None

    def normalize2origin(self):
        T = self._ensure_abs()
        self._set_abs(inv_se3(T[0]) @ T)

    def normalize2center(self):
        T = self._ensure_abs()
        self._set_abs(inv_se3(T[len(T) // 2]) @ T)

    def left_rotate(self, extrinsic):
        assert extrinsic.shape == (4, 4)
        self._set_abs(np.asarray(extrinsic) @ self._ensure_abs())

    def right_rotate(self, extrinsic):
        assert extrinsic.shape == (4, 4)
        self._set_abs(self._ensure_abs() @ np.asarray(extrinsic))

    def transform(self, extrinsic):
        """Conjugate the whole sequence: E @ T_i @ E^-1 — re-expresses a
        sensor-A trajectory in sensor-B coordinates
        (cama/pose_transformer.py:539-561)."""
        assert extrinsic.shape == (4, 4)
        E = np.asarray(extrinsic, dtype=np.float64)
        self._set_abs(E @ self._ensure_abs() @ inv_se3(E))

    def sort_by_timestamps(self):
        if self.timestamps.shape[0] < 2:
            raise RuntimeError(f"there are only {self.timestamps.shape[0]} timestamps")
        order = np.argsort(self.timestamps[:, 0])
        if self._abs is not None and len(self._abs) == self.timestamps.shape[0]:
            self._abs = self._abs[order]
        elif self._rel is not None and len(self._rel) == self.timestamps.shape[0]:
            self._rel = self._rel[order]
        else:
            raise NotImplementedError("whooops! not supported yet")
        self.timestamps = self.timestamps[order]

    # ---------------- seeking ----------------

    def seek_by_timestamp(self, query_time, t_max_diff, interpolate=False):
        """Single-query seek with the reference's RuntimeError contract."""
        T = self._ensure_abs()
        if self.timestamps.shape[0] == 0:
            raise RuntimeError("No timestamps found, pleas load timestamps first")
        ts = self.timestamps[:, 0]
        assert np.all(ts[1:] >= ts[:-1]), "timestamps must be sorted"
        out, valid = seek_by_timestamps(
            ts, T, np.asarray([query_time]), t_max_diff, interpolate=interpolate
        )
        if not bool(valid[0]):
            raise RuntimeError(
                f"query_time {query_time} has no pose within t_max_diff {t_max_diff}"
            )
        return out[0]

    def seek_many(self, query_times, t_max_diff, interpolate=True):
        """Batched seek: returns (T[M,4,4], valid[M]) without raising."""
        T = self._ensure_abs()
        ts = self.timestamps[:, 0]
        assert np.all(ts[1:] >= ts[:-1]), "timestamps must be sorted"
        return seek_by_timestamps(ts, T, np.asarray(query_times), t_max_diff, interpolate)
