"""nuScenes -> CAMA clip conversion (reference: dataset/nuscenes2clip.py:431-728).

A copy of cama_tpu/convert/nuscenes.py for the PyTorch port (that module
imports jax through cama_tpu.se3; this one takes quat_to_matrix from
cama_tpu_torch.se3).  Host-side I/O + metadata wrangling, no device work,
producing the exact on-disk clip contract of SURVEY.md §2.2:
attribute.json (ms sync/unsync tables + calibration), per-sensor data dirs
keyed by ms timestamps, TUM odometry (wigo + mid-trajectory-recentered
offset), and maps/map_nuscenes.json.

The nuScenes devkit is optional: all DB access goes through a small adapter
surface (`NuScenesDB` wraps the devkit; tests inject an in-memory fake), so
conversion logic is fully testable without the 300 GB dataset.

Reference quirks preserved:
  * scene record match uses substring ("name in scene_name",
    nuscenes2clip.py:687)
  * LiDAR bins are read as float64 [N, 4] and zero-padded to [N, 6]
    (nuscenes2clip.py:552-554)
  * wigo stats for the map patch use max/min over ALL TUM columns
    (timestamp included) with mid_idx = N//2 + 1 (nuscenes2clip.py:622-632)
  * rear camera fov 110, others 70; intrinsics fixed at 1600x900, zero
    distortion (nuscenes2clip.py:509-521)
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from copy import deepcopy

import numpy as np

from cama_tpu_torch.convert.vecmap import VectorizedLocalMap
from cama_tpu_torch.se3 import quat_to_matrix

logger = logging.getLogger(__name__)

CLIP_SENSOR_NAMES = [
    "camera_front", "camera_front_right", "camera_front_left",
    "camera_rear", "camera_rear_left", "camera_rear_right",
    "lidar_top",
]
SCENE_SENSOR_NAMES = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
    "LIDAR_TOP",
]


class NuScenesDB:
    """Adapter over the nuScenes devkit (optional dependency)."""

    def __init__(self, version, dataroot):
        from nuscenes.nuscenes import NuScenes

        self.nusc = NuScenes(version=version, dataroot=dataroot, verbose=True)
        self.dataroot = dataroot

    @property
    def samples(self):
        return list(self.nusc.sample)

    @property
    def scenes(self):
        return list(self.nusc.scene)

    def get(self, table, token):
        return self.nusc.get(table, token)

    def cam_intrinsic(self, cam_token):
        _, _, intrinsic = self.nusc.get_sample_data(cam_token)
        return np.asarray(intrinsic)

    def file_path(self, filename):
        return os.path.join(self.dataroot, filename)

    def map_source(self):
        return NuScenesMapSource(self.dataroot)


class NuScenesMapSource:
    """Map-layer adapter over NuScenesMap/NuScenesMapExplorer."""

    MAPS = ["boston-seaport", "singapore-hollandvillage",
            "singapore-onenorth", "singapore-queenstown"]

    def __init__(self, dataroot):
        from nuscenes.map_expansion.map_api import NuScenesMap

        self.apis = {loc: NuScenesMap(dataroot=dataroot, map_name=loc) for loc in self.MAPS}

    def line_layer(self, location, layer):
        api = self.apis[location]
        out = []
        for record in getattr(api, layer):
            line = api.extract_line(record["line_token"])
            if line.is_empty:
                continue
            out.append(np.asarray(line.coords))
        return out

    def polygon_layer(self, location, layer):
        api = self.apis[location]
        out = []
        for record in getattr(api, layer):
            tokens = record.get("polygon_tokens", [record.get("polygon_token")])
            for token in tokens:
                poly = api.extract_polygon(token)
                if not poly.is_valid or poly.is_empty:
                    continue
                ext = np.asarray(poly.exterior.coords)[:-1]
                holes = [np.asarray(h.coords)[:-1] for h in poly.interiors]
                out.append((ext, holes))
        return out


class NuScenesConverter:
    """Reference nuScenes2Clip equivalent (nuscenes2clip.py:431-712)."""

    def __init__(self, configs, db=None):
        self.configs = configs
        self.db = db if db is not None else NuScenesDB(configs["version"], configs["dataroot"])
        self.samples = self.db.samples
        self.clip_sensor_names = list(CLIP_SENSOR_NAMES)
        self.scene_sensor_names = list(SCENE_SENSOR_NAMES)

    # ---------------- pieces ----------------

    def compute_extrinsic2chassis(self, sd):
        cs = self.db.get("calibrated_sensor", sd["calibrated_sensor_token"])
        q = cs["rotation"]  # w x y z
        rot = quat_to_matrix(np.asarray([q[1], q[2], q[3], q[0]], dtype=np.float64))
        T = np.eye(4)
        T[:3, :3] = rot
        T[:3, 3] = cs["translation"]
        return T

    def get_scene_by_name(self, scene_name):
        for scene in self.db.scenes:
            if scene["name"] == scene_name:
                return scene
        return None

    def get_sensor_tokens(self, records):
        out = {}
        for idx, sensor_name in enumerate(self.clip_sensor_names):
            token = records[0]["data"][self.scene_sensor_names[idx]]
            out[sensor_name] = [token]
            sd = self.db.get("sample_data", token)
            while sd["next"]:
                out[sensor_name].append(sd["next"])
                sd = self.db.get("sample_data", sd["next"])
        return out

    def write_odometry(self, clip_root, sweeps_sd_tokens):
        frames = []
        for sensor_name in self.clip_sensor_names:
            frames += [self.db.get("sample_data", t) for t in sweeps_sd_tokens[sensor_name]]
        frames.sort(key=lambda x: x["timestamp"])
        od_path = os.path.join(clip_root, "odometry")
        os.makedirs(od_path, exist_ok=True)
        rows = []
        for sd in frames:
            pose = self.db.get("ego_pose", sd["ego_pose_token"])
            r, t = pose["rotation"], pose["translation"]
            rows.append([sd["timestamp"] / 1e6, t[0], t[1], t[2], r[1], r[2], r[3], r[0]])
        tum = np.array(rows)
        np.savetxt(os.path.join(od_path, "wigo.txt"), tum)
        utm_center = deepcopy(tum[int(len(tum) / 2), 1:4])
        tum[:, 1:4] = tum[:, 1:4] - deepcopy(utm_center)
        np.savetxt(os.path.join(od_path, "wigo_offset_clip.txt"), tum)

    def write_sensors(self, sweeps_sd_tokens, clip_root, n_threads=8):
        """Copy camera JPEGs / rewrite lidar bins keyed by millisecond
        timestamps (reference: nuscenes2clip.py:531-557, incl. the float64
        Nx4 -> Nx6 zero-pad quirk).  The file copies fan out over a thread
        pool — this loop is pure I/O and dominates conversion wall-clock in
        the reference's serial form (SURVEY §3.2); the on-disk bytes and the
        unsync table order are unchanged."""
        from concurrent.futures import ThreadPoolExecutor

        unsync = {}
        for sensor_name in self.clip_sensor_names:
            os.makedirs(os.path.join(clip_root, sensor_name), exist_ok=True)

        def rewrite_lidar(src, dst):
            pc = np.fromfile(src, dtype=np.double, count=-1).reshape([-1, 4])
            pc = np.hstack([pc, np.zeros((pc.shape[0], 2))])
            pc.tofile(dst)

        futures = []
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            for sensor_name in self.clip_sensor_names:
                logger.info("Writing %s data", sensor_name)
                unsync[sensor_name] = []
                for token in sweeps_sd_tokens[sensor_name]:
                    sd = self.db.get("sample_data", token)
                    src = self.db.file_path(sd["filename"])
                    dst_dir = os.path.join(clip_root, sensor_name)
                    ms = round(sd["timestamp"] / 1000)
                    if "lidar" not in sensor_name:
                        futures.append(pool.submit(
                            shutil.copy, src, os.path.join(dst_dir, f"{ms}.jpg")))
                    else:
                        futures.append(pool.submit(
                            rewrite_lidar, src, os.path.join(dst_dir, f"{ms}.bin")))
                    unsync[sensor_name].append(ms)
            for f in futures:
                f.result()  # propagate I/O errors with their tracebacks
        return unsync

    def get_sync_info(self, unsync, ref_sensor, max_diff):
        sync = {s: [] for s in unsync}
        for ref_ts in unsync[ref_sensor]:
            row = []
            for sensor in unsync:
                if sensor == ref_sensor:
                    row.append(ref_ts)
                    continue
                arr = np.asarray(unsync[sensor])
                k = int(np.abs(arr - ref_ts).argmin())
                if abs(int(arr[k]) - ref_ts) <= max_diff:
                    row.append(int(arr[k]))
            if len(row) == len(unsync):
                for sensor, ts in zip(unsync, row):
                    sync[sensor].append(ts)
        return sync

    def get_calibration(self, records):
        calibration = {}
        record = records[0]
        for cam_index, cam in enumerate(self.scene_sensor_names[:-1]):
            cam_token = record["data"][cam]
            sd_cam = self.db.get("sample_data", cam_token)
            cam2chassis = self.compute_extrinsic2chassis(sd_cam)
            K = self.db.cam_intrinsic(cam_token)
            name = self.clip_sensor_names[cam_index]
            calibration[f"{name}_2_chassis"] = cam2chassis.tolist()
            calibration[name] = {
                "center_u": K[0, 2], "center_v": K[1, 2],
                "distort": [0] * 8,
                "focal_u": K[0, 0], "focal_v": K[1, 1],
                "fov": 110 if cam == "CAM_BACK" else 70,
                "image_height": 900, "image_width": 1600,
                "K": K.tolist(), "d": [0] * 8,
            }
        lidar_token = records[0]["data"]["LIDAR_TOP"]
        sd = self.db.get("sample_data", lidar_token)
        calibration["lidar_top_2_chassis"] = self.compute_extrinsic2chassis(sd).tolist()
        return calibration

    def get_nusc_map(self, scene):
        scene_name = scene["name"]
        wigo = np.loadtxt(os.path.join(
            self.configs["converted_dataroot"], scene_name, "odometry/wigo.txt"))
        mid_idx = int(wigo.shape[0] / 2) + 1
        mid = wigo[mid_idx]
        wigo_max, wigo_min = wigo.max(axis=0), wigo.min(axis=0)
        diff = wigo_max - wigo_min
        patch_center = (wigo_min[1] + diff[1] / 2, wigo_min[2] + diff[2] / 2)
        patch_size = (diff[2] + 25, diff[1] + 25)  # (h, w)
        location = self.db.get("log", scene["log_token"])["location"]
        ego_t = mid[1:4].tolist()
        ego_r = [mid[7]] + mid[4:7].tolist()  # wxyz

        vm = VectorizedLocalMap(self.db.map_source(), patch_size=patch_size)
        anns = vm.gen_vectorized_samples(location, ego_t, ego_r, patch_size, patch_center)
        out = []
        for label, vec in zip(anns["gt_vecs_label"], anns["gt_vecs_pts_loc"]):
            coords = np.asarray(vec)
            out.append({
                "attrs": {"type": self.configs["map_classes"][label]},
                "data": coords.tolist(),
                "id": -1,
                "luid": "auto",
                "point_attrs": [[] for _ in range(len(coords))],
                "shape_type": "polyline",
                "struct_type": "parsing",
                "track_id": -1,
            })
        return out

    # ---------------- top level ----------------

    def convert(self, scene_name):
        scene = self.get_scene_by_name(scene_name)
        clip_root = os.path.join(self.configs["converted_dataroot"], scene_name)
        os.makedirs(clip_root, exist_ok=True)

        start_time = round(self.db.get("sample", scene["first_sample_token"])["timestamp"] / 1000)
        end_time = round(self.db.get("sample", scene["last_sample_token"])["timestamp"] / 1000)
        attr = {
            "start_time": start_time,
            "end_time": end_time,
            "status": "init",
            "calibration": {},
        }

        records = [s for s in self.samples
                   if self.db.get("scene", s["scene_token"])["name"] in scene_name]
        records.sort(key=lambda x: x["timestamp"])

        sweeps = self.get_sensor_tokens(records)
        self.write_odometry(clip_root, sweeps)
        unsync = self.write_sensors(sweeps, clip_root)
        attr["unsync"] = unsync
        attr["sync"] = self.get_sync_info(unsync, "camera_front", 40)
        attr["calibration"] = self.get_calibration(records)
        with open(os.path.join(clip_root, "attribute.json"), "w") as f:
            json.dump(attr, f, indent=4, ensure_ascii=False)

        nusc_map = self.get_nusc_map(scene)
        map_dir = os.path.join(clip_root, self.configs["cama_configs"]["result_dir"])
        os.makedirs(map_dir, exist_ok=True)
        with open(os.path.join(map_dir, "map_nuscenes.json"), "w") as f:
            json.dump(nusc_map, f, indent=4, ensure_ascii=False)
        return clip_root
