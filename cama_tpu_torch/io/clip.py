"""Reader for the CAMA on-disk clip format: the part of
cama_tpu/io/clip.py's ClipReader that scene compilation and the overlay
path read (timestamp tables, sensor file iterators, calibration graph,
odometry, label maps).

A copy, because cama_tpu.io.clip imports cama_tpu.se3.core, which imports
jax whenever it is installed.  Same results as the original
(tests/test_torch_host.py).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict, deque

import numpy as np

from cama_tpu_torch.se3 import inv_se3


class ClipReader:
    def __init__(self, clip_path=None):
        self.attribute = {}
        self.clip_path = ""
        self._graph = None
        if clip_path:
            self.read(clip_path)

    def read(self, clip_path):
        self.clip_path = str(clip_path)
        attr_path = os.path.join(self.clip_path, "attribute.json")
        if not os.path.exists(attr_path):
            raise FileNotFoundError(f"can not find {attr_path}")
        with open(attr_path, "r") as f:
            self.attribute = json.load(f)
        self._graph = None
        return self

    # ---------------- timestamps & files ----------------

    def sensor_timestamps_ms(self, sensor, sync=True):
        return list(self.attribute["sync" if sync else "unsync"][sensor])

    def sensor_timestamps(self, sensor, sync=True):
        """Seconds, float64 (ms / 1000.0)."""
        return np.asarray(self.sensor_timestamps_ms(sensor, sync), dtype=np.float64) / 1000.0

    def sensor_filepath(self, sensor, timestamp_ms, ext):
        return os.path.join(self.clip_path, sensor, f"{timestamp_ms}.{ext}")

    def iter_sensor_files(self, sensor, ext, sync=True, start_idx=None, end_idx=None,
                          start_time=None, end_time=None):
        """Yield (ts_ms, path) for a sensor, sliced by index or by time range
        in seconds: frames with start_time <= t < end_time."""
        ts_list = self.sensor_timestamps_ms(sensor, sync)
        if start_time is not None or end_time is not None:
            ts_s = np.asarray(ts_list, dtype=np.float64) / 1000.0
            lo = 0 if start_time is None else int(np.searchsorted(ts_s, start_time, "left"))
            hi = len(ts_list) if end_time is None else int(np.searchsorted(ts_s, end_time, "left"))
            ts_list = ts_list[lo:hi]
        else:
            ts_list = ts_list[start_idx:end_idx]
        for ts in ts_list:
            yield ts, self.sensor_filepath(sensor, ts, ext)

    def iter_camera(self, camera="camera_front", start_idx=None, end_idx=None):
        """Yield (ts_s, image BGR) decoded camera frames (needs cv2)."""
        import cv2

        for ts, path in self.iter_sensor_files(camera, "jpg", sync=True,
                                               start_idx=start_idx, end_idx=end_idx):
            yield ts / 1000.0, cv2.imread(path)

    def iter_semantic(self, camera="camera_front", start_idx=None, end_idx=None):
        """Yield (ts_s, path) of seg_{camera} PNGs."""
        for ts, path in self.iter_sensor_files(camera, "png", sync=True,
                                               start_idx=start_idx, end_idx=end_idx):
            yield ts / 1000.0, path.replace(camera, "seg_" + camera)

    def odometry(self, name_txt):
        """Raw TUM array from odometry/<name_txt>."""
        return np.loadtxt(os.path.join(self.clip_path, "odometry", name_txt))

    def map_json(self, result_dir, name):
        with open(os.path.join(self.clip_path, result_dir, name), "r") as f:
            return json.load(f)

    def height_grid(self, result_dir, name):
        return np.load(os.path.join(self.clip_path, result_dir, name))

    # ---------------- calibration ----------------

    def _direct_extrinsic(self, a, b):
        if a == b:
            return np.eye(4, dtype=np.float64)
        calib = self.attribute["calibration"]
        if f"{a}_2_{b}" in calib:
            return np.asarray(calib[f"{a}_2_{b}"], dtype=np.float64)
        if f"{b}_2_{a}" in calib:
            return inv_se3(np.asarray(calib[f"{b}_2_{a}"], dtype=np.float64))
        return None

    def _build_graph(self):
        graph = defaultdict(list)
        for key in self.attribute["calibration"]:
            if "_2_" in key:
                a, b = key.split("_2_")
                graph[a].append(b)
                graph[b].append(a)
        self._graph = graph

    def extrinsic_path(self, a, b):
        """Shortest path in the sensor graph (breadth-first)."""
        if self._graph is None:
            self._build_graph()
        if a == b:
            return None
        seen = {a}
        queue = deque([[a]])
        while queue:
            path = queue.popleft()
            for nb in self._graph[path[-1]]:
                if nb == b:
                    return path + [nb]
                if nb not in seen:
                    seen.add(nb)
                    queue.append(path + [nb])
        return None

    def extrinsic(self, from_sensor, to_sensor):
        """4x4 from_sensor -> to_sensor, composed along the graph path with
        edge inversion as needed; None when the graph is disconnected."""
        direct = self._direct_extrinsic(from_sensor, to_sensor)
        if direct is not None:
            return direct
        path = self.extrinsic_path(from_sensor, to_sensor)
        if path is None:
            print("extrinsic path not found!")
            return None
        out = np.eye(4, dtype=np.float64)
        for i in range(len(path) - 1):
            out = self._direct_extrinsic(path[i], path[i + 1]) @ out
        return out

    def intrinsics(self, sensor):
        """dict with K [3,3], d, width, height, hfov."""
        raw = self.attribute["calibration"][sensor]
        return {
            "K": np.asarray(raw.get("K"), dtype=np.float64),
            "d": np.asarray(raw.get("d"), dtype=np.float64),
            "width": raw.get("image_width"),
            "height": raw.get("image_height"),
            "hfov": raw.get("fov"),
        }
