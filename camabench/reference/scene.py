"""A clip as the reference sees it: calibration, frame times, lifted label
points per source and each frame's chassis-to-world pose, in float64.

The semantics are CAMA's (cama/reproject.py, cama/dataset.py): CAMA labels
are polylines in BEV pixels of 0.1 m on a 600 m map, densified at steps of
0.1 (pixel units), lifted with the nearest height of the BEV grid; nuScenes
labels are polylines in metres in the centre pose's frame, densified at
0.1 m, at height 0.  The CAMA pose chain is the SfM pose of camera_front
times chassis->camera_front; the nuScenes chain is the offset ego odometry
re-expressed relative to its middle row.  A frame's pose is interpolated at
the synchronised camera_front time, translation linearly and rotation along
the shortest arc; frames from index 1 on are served, and a frame whose
bracketing poses lie more than 0.5 s apart is not.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

SOLUTION = 0.1
T_MAX_DIFF = 0.5
START_INDEX = 1
# the renderer's colours, BGR: lane markings grey, every other class in the
# crosswalk colour (cama/reproject.py:11-17, :251-253)
LANE_BGR = np.array([211, 211, 211], np.uint8)
OTHER_BGR = np.array([0, 215, 255], np.uint8)


@dataclass
class ClipData:
    path: str
    cameras: list
    K_orig: np.ndarray          # [C, 3, 3]
    d: np.ndarray               # [C, 8]
    K_out: np.ndarray           # [C, 3, 3] rescaled to the output size
    chassis2cam: np.ndarray     # [C, 4, 4]
    image_size: tuple           # (h, w) of the source images
    output_size: tuple          # (h, w)
    frame_times: np.ndarray     # [N] seconds, synchronised camera_front
    sync_ms: dict               # camera -> [N] ms
    points: dict = field(default_factory=dict)   # source -> [P, 3] float64
    lane: dict = field(default_factory=dict)     # source -> [P] bool
    pose_table: dict = field(default_factory=dict)  # source -> (ts, T)


def _read_tum(path):
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 8)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :3] = quat_to_matrix(rows[:, 4:8])
    T[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], T


def quat_to_matrix(q):
    """(x, y, z, w) unit quaternions [N, 4] -> rotations [N, 3, 3]."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rigid_inverse(T):
    out = np.tile(np.eye(4), T.shape[:-2] + (1, 1))
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return out


def _log_so3(R):
    """Rotation vector of R (angles below pi)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    scale = 0.5 * (1.0 + th * th / 6.0) if th < 1e-4 else th / (2.0 * np.sin(th))
    return scale * v


def _exp_so3(w):
    th = np.linalg.norm(w)
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-4:
        a, b = 1.0 - th * th / 6.0, 0.5 - th * th / 24.0
    else:
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / (th * th)
    return np.eye(3) + a * K + b * (K @ K)


def interpolate_pose(ts, T, t):
    """Chassis-to-world at time t from the table (ts, T), or None when t
    lies outside it or its bracket spans more than T_MAX_DIFF."""
    tol = 1e-9 + 1e-20 * abs(t)
    hit = np.flatnonzero(np.abs(ts - t) <= tol)
    if len(hit):
        return T[hit[0]].copy()
    r = int(np.searchsorted(ts, t, side="left"))
    if r == 0 or r >= len(ts):
        return None
    gap = ts[r] - ts[r - 1]
    if gap <= 0 or gap > T_MAX_DIFF:
        return None
    a = (t - ts[r - 1]) / gap
    out = np.eye(4)
    out[:3, 3] = (1 - a) * T[r - 1, :3, 3] + a * T[r, :3, 3]
    R0 = T[r - 1, :3, :3]
    out[:3, :3] = R0 @ _exp_so3(a * _log_so3(R0.T @ T[r, :3, :3]))
    return out


def _densify(poly):
    """[M, 2] float64 -> points every 1/SOLUTION-th of each segment
    (int(length / SOLUTION) of them, from the segment's start)."""
    out = []
    for a, b in zip(poly[:-1], poly[1:]):
        seg = b - a
        num = int(np.linalg.norm(seg) / SOLUTION)
        if num:
            out.append(a + (seg / num) * np.arange(num)[:, None])
    return np.concatenate(out) if out else np.zeros((0, 2))


def lift_cama(labels, grid, map_size_m):
    """(points [P, 3], lane [P] bool) of CAMA BEV-pixel polylines."""
    pts, lane = [], []
    for inst in labels:
        if len(inst["data"]) <= 1:
            continue
        dense = _densify(np.asarray(inst["data"], np.float64))
        if not len(dense):
            continue
        idx = np.clip(np.rint(dense).astype(np.int64), 0, grid.shape[0] - 1)
        z = grid[idx[:, 1], idx[:, 0]].astype(np.float64)
        x = dense[:, 1] * SOLUTION - map_size_m / 2
        y = dense[:, 0] * SOLUTION - map_size_m / 2
        pts.append(np.stack([x, y, z], -1))
        lane.append(np.full(len(dense), inst["attrs"]["type"] == "lane_marking"))
    return np.concatenate(pts), np.concatenate(lane)


def lift_nuscenes(labels):
    """(points [P, 3], lane [P] bool) of metric polylines at height 0."""
    pts, lane = [], []
    for inst in labels:
        if len(inst["data"]) <= 1:
            continue
        dense = _densify(np.asarray(inst["data"], np.float64))
        if not len(dense):
            continue
        pts.append(np.concatenate([dense, np.zeros((len(dense), 1))], -1))
        lane.append(np.full(len(dense), inst["attrs"]["type"] == "lane_marking"))
    return np.concatenate(pts), np.concatenate(lane)


def load_clip(path, cameras, output_size, sources, map_size_m=600.0,
              camera_main="camera_front"):
    """ClipData of the clip directory `path`."""
    with open(os.path.join(path, "attribute.json")) as f:
        attr = json.load(f)
    calib = attr["calibration"]
    C = len(cameras)
    K_orig, K_out = np.zeros((C, 3, 3)), np.zeros((C, 3, 3))
    d = np.zeros((C, 8))
    chassis2cam = np.zeros((C, 4, 4))
    oh, ow = output_size
    for i, cam in enumerate(cameras):
        K = np.asarray(calib[cam]["K"], np.float64)
        w, h = calib[cam]["image_width"], calib[cam]["image_height"]
        K_orig[i] = K
        dd = np.asarray(calib[cam]["d"], np.float64)
        d[i, :len(dd)] = dd
        K_out[i] = K * np.array([[ow / w], [oh / h], [1.0]])
        chassis2cam[i] = rigid_inverse(np.asarray(calib[f"{cam}_2_chassis"], np.float64))
    clip = ClipData(
        path=path, cameras=list(cameras), K_orig=K_orig, d=d, K_out=K_out,
        chassis2cam=chassis2cam, image_size=(h, w), output_size=tuple(output_size),
        frame_times=np.asarray(attr["sync"][camera_main], np.float64) / 1000.0,
        sync_ms={k: list(v) for k, v in attr["sync"].items()})
    odo = os.path.join(path, "odometry")
    maps = os.path.join(path, "maps")
    if "cama" in sources:
        with open(os.path.join(maps, "map_labels.json")) as f:
            labels = json.load(f)
        grid = np.load(os.path.join(maps, "vision_road_mlp_ft.npy"))
        clip.points["cama"], clip.lane["cama"] = lift_cama(labels, grid, map_size_m)
        ts, T = _read_tum(os.path.join(odo, f"scmv_{camera_main}.txt"))
        main = cameras.index(camera_main)
        clip.pose_table["cama"] = (ts, T @ chassis2cam[main])
    if "nuscenes" in sources:
        with open(os.path.join(maps, "map_nuscenes.json")) as f:
            clip.points["nuscenes"], clip.lane["nuscenes"] = lift_nuscenes(json.load(f))
        ts, T = _read_tum(os.path.join(odo, "wigo_offset_clip.txt"))
        clip.pose_table["nuscenes"] = (ts, rigid_inverse(T[len(T) // 2]) @ T)
    return clip


def served_frames(clip, source):
    """[(image_idx, chassis2world [4, 4])] of the frames a source serves."""
    ts, T = clip.pose_table[source]
    out = []
    for idx in range(START_INDEX, len(clip.frame_times)):
        pose = interpolate_pose(ts, T, clip.frame_times[idx])
        if pose is not None:
            out.append((idx, pose))
    return out
