"""Synthetic fixture clip in the CAMA on-disk format, without jax.

A copy of cama_tpu/io/fixture.py's `make_fixture_clip` for the options the
overlay path uses (camera images optional; no LiDAR, auxiliary sensors,
site frames or dropped poses): a vehicle drives ~3 m/s along +x near world
(-240, -240) past three lane markings, two road edges and a crosswalk.  It
writes attribute.json, odometry, both label maps and the height grid, and
optionally per-camera JPEGs.  For the same arguments it writes the same
bytes as the original (tests/test_torch_host.py).  `add_instance_masks`
adds the ground-truth instance masks map evaluation reads, again the same
bytes as the original's (tests/test_torch_eval_scene.py).
"""
from __future__ import annotations

import json
import os

import numpy as np

from cama_tpu_torch.se3 import inv_se3, matrix_to_quat

CAMERA_LIST = [
    "camera_front_left", "camera_front", "camera_front_right",
    "camera_rear_left", "camera_rear", "camera_rear_right",
]
CAMERA_YAWS_DEG = {
    "camera_front": 0.0,
    "camera_front_left": 55.0,
    "camera_front_right": -55.0,
    "camera_rear_left": 110.0,
    "camera_rear_right": -110.0,
    "camera_rear": 180.0,
}
GRID_SIZE = 1200  # BEV height grid
FPS = 10.0
T0_MS = 1600000000000  # clip start, unix milliseconds
IMAGE_SIZE = (1600, 900)  # (width, height) of the camera images


def _cam2chassis(camera_name):
    """Camera (z fwd, x right, y down) pose in chassis (x fwd, y left, z up)."""
    yaw = np.deg2rad(CAMERA_YAWS_DEG[camera_name])
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    cz, sz = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    T = np.eye(4)
    T[:3, :3] = Rz @ base
    T[:3, 3] = Rz @ np.array([1.5, 0.0, 0.0]) + np.array([0.0, 0.0, 1.6])
    return T


def _pose_chassis2world(t_rel):
    """Smooth synthetic trajectory; t_rel in seconds (scalar or [N])."""
    t = np.atleast_1d(np.asarray(t_rel, dtype=np.float64))
    x = -270.0 + 3.0 * t
    y = -240.0 + 1.5 * np.sin(0.35 * t)
    z = 0.5 + 0.05 * np.sin(0.2 * t)
    yaw = np.arctan2(1.5 * 0.35 * np.cos(0.35 * t), 3.0)
    pitch = 0.01 * np.sin(0.15 * t)
    n = len(t)
    T = np.tile(np.eye(4), (n, 1, 1))
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Rz = np.zeros((n, 3, 3)); Ry = np.zeros((n, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1], Rz[:, 2, 2] = cy_, -sy_, sy_, cy_, 1.0
    Ry[:, 0, 0], Ry[:, 0, 2], Ry[:, 2, 0], Ry[:, 2, 2], Ry[:, 1, 1] = cp, sp, -sp, cp, 1.0
    T[:, :3, :3] = Rz @ Ry
    T[:, :3, 3] = np.stack([x, y, z], axis=-1)
    return T


def _world_xy_to_label_px(wxy):
    """World meters -> CAMA BEV label pixels (column 0 <- world y, column 1
    <- world x)."""
    wxy = np.asarray(wxy, dtype=np.float64)
    return np.stack([(wxy[:, 1] + 300.0) * 10.0, (wxy[:, 0] + 300.0) * 10.0], axis=-1)


def _world_polylines(label_span):
    """(class_name, vertices[N, 2] world meters); label_span stretches the
    longitudinal extent (a long span leaves most points outside the crop)."""
    xs = np.linspace(label_span[0], label_span[1], 9)
    lines = []
    for wy in (-243.0, -240.0, -237.0):
        pts = np.stack([xs, np.full_like(xs, wy) + 0.4 * np.sin(0.08 * xs)], axis=-1)
        lines.append(("lane_marking", pts))
    for wy in (-246.5, -233.5):
        pts = np.stack([xs, np.full_like(xs, wy)], axis=-1)
        lines.append(("Road_teeth", pts))
    for wx in (-231.0, -230.2, -229.4):
        ys = np.linspace(-246.0, -234.0, 4)
        pts = np.stack([np.full_like(ys, wx), ys], axis=-1)
        lines.append(("Crosswalk_Line", pts))
    return lines


def _height_grid():
    r = np.arange(GRID_SIZE, dtype=np.float32)
    rr, cc = np.meshgrid(r, r, indexing="ij")
    return (0.25 * np.sin(rr / 37.0) * np.cos(cc / 53.0)).astype(np.float32)


def _label_record(cls, data_xy):
    return {
        "attrs": {"type": cls},
        "data": np.asarray(data_xy, dtype=np.float64).tolist(),
        "id": -1,
        "luid": "auto",
        "point_attrs": [[] for _ in range(len(data_xy))],
        "shape_type": "polyline",
        "struct_type": "parsing",
        "track_id": -1,
    }


def _synth_image(camera, frame_idx, width, height):
    """Deterministic patterned image (BGR uint8, like cv2.imread output)."""
    u = np.arange(width, dtype=np.float32)[None, :]
    v = np.arange(height, dtype=np.float32)[:, None]
    c = CAMERA_LIST.index(camera)
    b = (127 + 80 * np.sin(u / 97.0 + c) * np.cos(v / 71.0 + frame_idx * 0.3))
    g = (127 + 80 * np.sin(u / 53.0 - frame_idx * 0.2) * np.cos(v / 89.0 + c))
    r = (127 + 80 * np.sin((u + v) / 127.0 + c + frame_idx * 0.1))
    img = np.stack([b + 0 * v, g + 0 * v, r + 0 * v], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_fixture_clip(root, scene_name="scene-fixture", n_frames=12,
                      with_images=True, label_span=(-278.0, -202.0)):
    """Build a clip directory under root/scene_name and return its path.
    with_images writes one JPEG per camera and frame (needs cv2)."""
    clip = os.path.join(str(root), scene_name)
    os.makedirs(clip, exist_ok=True)
    width, height = IMAGE_SIZE
    fps, t0_ms = FPS, T0_MS

    # ---- timestamps (ms ints) ----
    frame_ms = {}
    cam_offsets = {cam: 2 * i for i, cam in enumerate(CAMERA_LIST)}
    for cam in CAMERA_LIST:
        frame_ms[cam] = [t0_ms + round(1000 * k / fps) + cam_offsets[cam] for k in range(n_frames)]
    lidar_period = round(500 / fps)  # 2x camera rate
    frame_ms["lidar_top"] = [t0_ms + lidar_period * k + 5 for k in range(2 * n_frames)]

    unsync = {s: list(v) for s, v in frame_ms.items()}
    # sync: nearest within 40 ms of camera_front
    sync = {s: [] for s in unsync}
    for ref_ts in unsync["camera_front"]:
        row = {}
        for s, tss in unsync.items():
            if s == "camera_front":
                row[s] = ref_ts
                continue
            arr = np.asarray(tss)
            k = int(np.abs(arr - ref_ts).argmin())
            if abs(int(arr[k]) - ref_ts) <= 40:
                row[s] = int(arr[k])
        if len(row) == len(unsync):
            for s, ts in row.items():
                sync[s].append(ts)

    # ---- calibration ----
    fx = fy = 1266.417
    cx, cy = width / 2 + 16.0, height / 2 + 41.0
    K = [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]
    calibration = {}
    for cam in CAMERA_LIST:
        calibration[f"{cam}_2_chassis"] = _cam2chassis(cam).tolist()
        calibration[cam] = {
            "center_u": cx, "center_v": cy,
            "distort": [0] * 8,
            "focal_u": fx, "focal_v": fy,
            "fov": 110 if cam == "camera_rear" else 70,
            "image_height": height, "image_width": width,
            "K": K, "d": [0] * 8,
        }
    T_lidar = np.eye(4)
    T_lidar[:3, 3] = [0.9, 0.0, 1.8]
    calibration["lidar_top_2_chassis"] = T_lidar.tolist()

    attribute = {
        "start_time": int(unsync["camera_front"][0]),
        "end_time": int(unsync["camera_front"][-1]),
        "status": "init",
        "calibration": calibration,
        "unsync": unsync,
        "sync": sync,
    }
    with open(os.path.join(clip, "attribute.json"), "w") as f:
        json.dump(attribute, f, indent=4, ensure_ascii=False)

    # ---- odometry ----
    od = os.path.join(clip, "odometry")
    os.makedirs(od, exist_ok=True)
    all_ms = sorted(ms for tss in unsync.values() for ms in tss)
    t_rel = (np.asarray(all_ms, dtype=np.float64) - t0_ms) / 1000.0
    T_wc = _pose_chassis2world(t_rel)
    quat = matrix_to_quat(T_wc[:, :3, :3])
    tum = np.concatenate(
        [np.asarray(all_ms, dtype=np.float64)[:, None] / 1000.0, T_wc[:, :3, 3], quat], axis=1
    )
    np.savetxt(os.path.join(od, "wigo.txt"), tum)
    tum_off = tum.copy()
    tum_off[:, 1:4] -= tum[len(tum) // 2, 1:4].copy()
    np.savetxt(os.path.join(od, "wigo_offset_clip.txt"), tum_off)

    # scmv: camera_front SfM poses (cam2world) at sync camera_front times
    cam_ms = np.asarray(sync["camera_front"], dtype=np.float64)
    T_w_cam = _pose_chassis2world((cam_ms - t0_ms) / 1000.0) @ _cam2chassis("camera_front")
    scmv = np.concatenate(
        [cam_ms[:, None] / 1000.0, T_w_cam[:, :3, 3], matrix_to_quat(T_w_cam[:, :3, :3])],
        axis=1,
    )
    np.savetxt(os.path.join(od, "scmv_camera_front.txt"), scmv)

    # ---- maps ----
    maps_dir = os.path.join(clip, "maps")
    os.makedirs(maps_dir, exist_ok=True)
    np.save(os.path.join(maps_dir, "vision_road_mlp_ft.npy"), _height_grid())
    cama_labels = [_label_record(cls, _world_xy_to_label_px(w))
                   for cls, w in _world_polylines(label_span)]
    with open(os.path.join(maps_dir, "map_labels.json"), "w") as f:
        json.dump(cama_labels, f)

    # nuScenes-style labels: meters, in the recentered mid-pose frame
    mid = len(tum) // 2
    T_center = T_wc[mid].copy()
    T_center[:3, 3] -= tum[mid, 1:4] - tum_off[mid, 1:4]  # translation after offset
    T_inv = inv_se3(T_center)
    nusc_labels = []
    for cls, w in _world_polylines(label_span):
        p = np.concatenate([w, np.zeros((len(w), 1)), np.ones((len(w), 1))], axis=1)
        p[:, :3] -= tum[mid, 1:4]
        q = (T_inv @ p.T).T
        nusc_labels.append(_label_record(cls, q[:, :2]))
    with open(os.path.join(maps_dir, "map_nuscenes.json"), "w") as f:
        json.dump(nusc_labels, f)

    # ---- images ----
    if with_images:
        import cv2

        for cam in CAMERA_LIST:
            cam_dir = os.path.join(clip, cam)
            os.makedirs(cam_dir, exist_ok=True)
            for k, ms in enumerate(unsync[cam]):
                cv2.imwrite(
                    os.path.join(cam_dir, f"{ms}.jpg"), _synth_image(cam, k, width, height)
                )
    return clip


def add_instance_masks(clip_path, source="cama", thickness=3, camera_list=CAMERA_LIST,
                       shift_px=0.0):
    """Generate `lane_ins_{camera}/<ms>.png` ground-truth instance masks by
    reprojecting the clip's own lifted labels with the host-exact path: the
    GT-mask artifact the map metrics consume (eval/map_metrics.py).  Masks
    are uint16 instance ids at the original camera resolution.  `shift_px`
    shifts the drawn mask to simulate annotation error (for metric
    sensitivity tests).  A copy of cama_tpu/io/fixture.py:add_instance_masks
    on this package's scene compiler and projection; needs cv2."""
    import cv2

    from cama_tpu_torch.io.scene import compile_scene
    from cama_tpu_torch.ops.geometry import (
        compose_frame_matrices,
        project_frame_exact,
    )

    scene = compile_scene(clip_path, sources=(source,))
    fm = compose_frame_matrices(
        scene.traj[source], scene.frame_times, scene.chassis2cam, scene.K_orig
    )
    fp = scene.flat[source]
    pts = fp.points[fp.valid]
    inst = fp.inst[fp.valid]
    h, w = scene.image_size
    for cam in camera_list:
        os.makedirs(os.path.join(clip_path, f"lane_ins_{cam}"), exist_ok=True)
    for k, image_idx in enumerate(fm.frame_indices):
        if not fm.frame_valid[k]:
            continue
        cam_outs = project_frame_exact(
            pts, np.linalg.inv(fm.chassis2world_f32[k]), scene.chassis2cam,
            scene.K_orig, w, h,
        )
        for c, cam in enumerate(camera_list):
            vu, keep = cam_outs[c]
            img = np.zeros((h, w), np.uint16)
            sel = np.flatnonzero(keep)
            for i in sel:
                v, u = vu[i]
                cv2.circle(img, (int(u), int(v + shift_px)), thickness,
                           int(inst[i]) + 1, -1)
            ms = scene.sync_ms[cam][int(image_idx)]
            cv2.imwrite(os.path.join(clip_path, f"lane_ins_{cam}", f"{ms}.png"), img)
    return clip_path
