"""Synthetic fixture clip in the CAMA on-disk format, without jax.

A copy of cama_tpu/io/fixture.py's `make_fixture_clip`: a vehicle drives
~3 m/s along +x near world (-240, -240) past three lane markings, two road
edges and a crosswalk.  It writes attribute.json, odometry, both label maps
and the height grid, and optionally per-camera JPEGs, LiDAR sweeps of a
static world, the IMU / GNSS / wheel streams, a clip in its own misaligned
SfM frame (the site scenario) and dropped SfM poses.  For the same
arguments it writes the same bytes as the original
(tests/test_torch_host.py, tests/test_torch_aggregate.py).  `add_instance_masks`
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


def make_fixture_clip(
    root,
    scene_name="scene-fixture",
    n_frames=12,
    fps=10.0,
    with_images=True,
    with_lidar=True,
    drop_scmv_rows=(),
    t0_ms=1600000000000,
    image_size=(1600, 900),
    seed=0,
    traj_t_offset=0.0,
    world_sim3=None,
    flat_height=False,
    with_aux_sensors=False,
    label_span=(-278.0, -202.0),
):
    """Build a clip directory under root/scene_name. Returns its path.

    traj_t_offset shifts the trajectory parameterization (seconds) so several
    clips cover overlapping road portions at different wall-clock times (the
    CAMAv2 site scenario).  world_sim3 = dict(yaw_deg, tx, ty) expresses this
    clip's SfM frame as an SE(2)-misaligned copy of the world frame: scmv
    poses AND CAMA labels are written in that frame (wigo stays global UTM),
    which site aggregation must undo.  flat_height zeroes the BEV height grid
    (keeps cross-clip z consistent for site tests)."""
    rng = np.random.default_rng(seed)

    if world_sim3 is None:
        M_sfm = np.eye(4)
    else:
        yaw = np.deg2rad(world_sim3.get("yaw_deg", 0.0))
        M_sfm = np.eye(4)
        M_sfm[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        M_sfm[0, 3] = world_sim3.get("tx", 0.0)
        M_sfm[1, 3] = world_sim3.get("ty", 0.0)

    def pose_at(t_rel):
        return _pose_chassis2world(np.asarray(t_rel) + traj_t_offset)
    clip = os.path.join(str(root), scene_name)
    os.makedirs(clip, exist_ok=True)
    width, height = image_size

    # ---- timestamps (ms ints) ----
    frame_ms = {}
    cam_offsets = {cam: 2 * i for i, cam in enumerate(CAMERA_LIST)}
    for cam in CAMERA_LIST:
        frame_ms[cam] = [t0_ms + round(1000 * k / fps) + cam_offsets[cam] for k in range(n_frames)]
    lidar_period = round(500 / fps)  # 2x camera rate
    frame_ms["lidar_top"] = [t0_ms + lidar_period * k + 5 for k in range(2 * n_frames)]
    if with_aux_sensors:
        # IMU 100 Hz, GNSS 10 Hz, wheel ~33 Hz
        span = round(1000 * n_frames / fps)
        frame_ms["IMU"] = [t0_ms + 10 * k for k in range(span // 10)]
        frame_ms["UB482"] = [t0_ms + 100 * k + 1 for k in range(span // 100)]
        frame_ms["wheel"] = [t0_ms + 30 * k + 2 for k in range(span // 30)]

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
    T_wc = pose_at(t_rel)
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
    T_cam2ch = _cam2chassis("camera_front")
    T_w_cam = M_sfm @ pose_at((cam_ms - t0_ms) / 1000.0) @ T_cam2ch
    keep = np.ones(len(cam_ms), dtype=bool)
    for i in drop_scmv_rows:
        if 0 <= i < len(keep):
            keep[i] = False
    scmv = np.concatenate(
        [cam_ms[:, None] / 1000.0, T_w_cam[:, :3, 3], matrix_to_quat(T_w_cam[:, :3, :3])],
        axis=1,
    )[keep]
    np.savetxt(os.path.join(od, "scmv_camera_front.txt"), scmv)

    # ---- maps ----
    maps_dir = os.path.join(clip, "maps")
    os.makedirs(maps_dir, exist_ok=True)
    # flat grid sits at the chassis base height so cama z matches the
    # nuScenes path's z=0-in-center-frame plane (world z ~= 0.5)
    grid = np.full((GRID_SIZE, GRID_SIZE), 0.5, np.float32) if flat_height else _height_grid()
    np.save(os.path.join(maps_dir, "vision_road_mlp_ft.npy"), grid)

    def to_sfm_px(w):
        wh = np.concatenate([w, np.zeros((len(w), 1)), np.ones((len(w), 1))], axis=1)
        return _world_xy_to_label_px((M_sfm @ wh.T).T[:, :2])

    cama_labels = [
        _label_record(cls, to_sfm_px(w)) for cls, w in _world_polylines(label_span)
    ]
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
        # offset world like wigo_offset does, then into center-pose frame
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

    # ---- aux sensor json (IMU / GNSS / wheel) ----
    if with_aux_sensors:
        def pose_for(ms):
            return pose_at((np.asarray(ms) - t0_ms) / 1000.0)

        imu = {}
        for ms in unsync["IMU"]:
            imu[str(ms)] = {
                "gyro": (0.01 * rng.normal(size=3)).tolist(),
                "accel": [0.0, 0.0, 9.81],
            }
        os.makedirs(os.path.join(clip, "IMU"), exist_ok=True)
        with open(os.path.join(clip, "IMU", "data.json"), "w") as f:
            json.dump(imu, f)

        gnss = {}
        for ms in unsync["UB482"]:
            T = pose_for(ms)[0]
            q = matrix_to_quat(T[:3, :3])
            gnss[str(ms)] = {  # v2 ("tat") schema: dict-valued
                "position": {"x": T[0, 3], "y": T[1, 3], "z": T[2, 3]},
                "orientation": {"x": q[0], "y": q[1], "z": q[2], "w": q[3]},
            }
        os.makedirs(os.path.join(clip, "UB482"), exist_ok=True)
        with open(os.path.join(clip, "UB482", "data.json"), "w") as f:
            json.dump(gnss, f)

        wheel = {}
        for ms in unsync["wheel"]:
            T = pose_for(ms)[0]
            yaw = float(np.arctan2(T[1, 0], T[0, 0]))
            wheel[str(ms)] = {"x": T[0, 3], "y": T[1, 3], "yaw": yaw}  # v2 schema
        os.makedirs(os.path.join(clip, "wheel"), exist_ok=True)
        with open(os.path.join(clip, "wheel", "data.json"), "w") as f:
            json.dump(wheel, f)

    # ---- lidar ----
    if with_lidar:
        lid_dir = os.path.join(clip, "lidar_top")
        os.makedirs(lid_dir, exist_ok=True)
        n_pts = 2048
        # world-frame content: ground plane + a wall along the road edge
        gx = rng.uniform(-275, -205, n_pts)
        gy = rng.uniform(-250, -230, n_pts)
        gz = np.where(gy < -246.0, rng.uniform(0, 2.5, n_pts), 0.0)
        world_pts = np.stack([gx, gy, gz, np.ones(n_pts)], axis=-1)
        T_l_inv = inv_se3(T_lidar)
        for ms in unsync["lidar_top"]:
            T_chassis = pose_at((ms - t0_ms) / 1000.0)[0]
            pts_l = (T_l_inv @ inv_se3(T_chassis) @ world_pts.T).T[:, :3]
            rec = np.concatenate(
                [
                    pts_l,
                    rng.uniform(0, 255, (n_pts, 1)),
                    np.zeros((n_pts, 1)),
                    np.full((n_pts, 1), ms / 1000.0),
                ],
                axis=1,
            ).astype(np.float64)
            rec.tofile(os.path.join(lid_dir, f"{ms}.bin"))

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
