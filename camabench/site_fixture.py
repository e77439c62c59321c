"""The CAMAv2 site's clips: one road network seen by several overlapping
member clips, each in CAMA's on-disk clip format and in its own SfM frame,
made from a configuration file (its `site` block) and a seed.

The network and the windows follow the port's seeded pseudo-site
(tools/site_cases.py, frozen here as `road_network`): rows `row_m` apart,
lane markings and road edges along them, stop lines across them, same-class
elements at least 6 m apart; clip c sees the elements whose midpoint lies
in its `window_m` window, the windows `window_m / overlap` apart, so that
every element is seen by up to `overlap` clips.  The network does not
depend on the seed (`network_seed`), so every seed gives the same elements,
instances and candidate pairs.

Per member clip, from the seed:

- each element's label is a polyline of a vertex every ~`vertex_spacing_m`
  along the element's gentle bow, each vertex off by the clip's own
  annotation noise (one of `label_noise_m`) and the ends by up to
  `end_jitter_m` along it.  Each segment's length is set to (n + 0.5)
  times the densify step (0.1 BEV pixel, 0.01 m), so that no point count
  sits on a rounding edge in float32 or float64, whatever rigid motion
  moves the network;
- the drive: 12 Hz camera frames around the window's centre at
  `speed_m_s`, in one lane, on a lane-change sway that keeps the Umeyama
  alignment well conditioned (singular-value ratio of the chassis track at
  least `min_sv_ratio`); the ego odometry runs at `odometry_hz`, and the
  chassis pose at a camera time is the odometry interpolated there
  (translation linearly, rotation along the shortest arc), so the track the
  SfM poses give and the odometry interpolated at the camera times agree
  exactly;
- the clip's SfM frame is the world moved to its window's centre with a
  seeded yaw and offset: the CAMA labels (BEV pixels of a 600 m map) and
  the SfM poses of camera_front are written in it;
- its `odometry/wigo.txt`, the world frame shared by the site (UTM-scale
  coordinates from `world_origin_m`), carries a seeded misregistration
  about the window's centre: a yaw of `misregistration.yaw_deg` either way
  and a shift of `misregistration.shift_m`.  Clip 0 is exact.  So the
  Umeyama estimate is off by exactly that, and the refinement has it to
  undo.

The road is flat (z = 0; the height grid is zeros, written once a checkout
and linked into each clip).  A label fix (draw n > 0) moves the whole
network by one seeded offset common to every clip, up to
`label_fix_m.along` along the rows and `label_fix_m.across` across them:
every point count is kept, and duplicates stay duplicates.

Nothing here imports the program under test.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

from camabench import fixture
from camabench.reference import scene as ref_scene

STEP_M = 0.01  # CAMA's densify step: 0.1 of a 0.1 m BEV pixel


def road_network(rng, n_rows, length, row_m):
    """[(class, start [2], end [2])] element segments of the network (a
    frozen copy of tools/site_cases.road_network)."""
    out = []
    for r in range(n_rows):
        for cls, dy in (("lane_marking", 0.0), ("Road_teeth", 5.0)):
            x = rng.uniform(0.0, 5.0)
            while x < length:
                seg = rng.uniform(15.0, 30.0)
                y = row_m * r + dy + rng.uniform(-0.2, 0.2)
                out.append((cls, np.array([x, y]),
                            np.array([min(x + seg, length), y + rng.uniform(-0.5, 0.5)])))
                x += seg + rng.uniform(6.0, 10.0)
    # stop lines every 30 m, one across each row's lane
    for x in np.arange(10.0, length, 30.0):
        for r in range(n_rows):
            xs = x + rng.uniform(-0.5, 0.5)
            out.append(("Crosswalk_Line", np.array([xs, row_m * r + 0.7]),
                        np.array([xs, row_m * r + 4.3])))
    return out


def network(site):
    """(elements, window starts [n_clips]) of a configuration's site block."""
    n = int(site["clips"])
    step = float(site["window_m"]) / float(site["overlap"])
    length = float(site["window_m"]) + step * (n - 1)
    rng = np.random.default_rng(int(site["network_seed"]))
    return road_network(rng, int(site["rows"]), length, float(site["row_m"])), \
        step * np.arange(n)


def _rigid(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _snapped(vertices):
    """The vertex chain with each segment's length set to (n + 0.5) densify
    steps, each vertex aimed at its target from the last one placed (so
    the chain stays within half a step of the targets)."""
    out = [vertices[0]]
    for v in vertices[1:]:
        d = v - out[-1]
        length = np.linalg.norm(d)
        n = max(1, int(np.floor(length / STEP_M)))
        out.append(out[-1] + d / length * (n + 0.5) * STEP_M)
    return np.asarray(out)


def sv_ratio(xyz):
    """Second over first singular value of a centred track."""
    sv = np.linalg.svd(xyz - xyz.mean(0), compute_uv=False)
    return float(sv[1] / sv[0])


class SiteClip:
    """What a seed fixes of member clip `index`: the label polylines in
    the network's coordinates (`lines`, with the network element each
    shows in `element_ids`), the drive, the SfM frame and the
    misregistration.  Nothing depends on the label draw."""

    def __init__(self, cfg, seed, index):
        site = cfg["site"]
        self.cfg, self.index = cfg, int(index)
        rng = np.random.default_rng(fixture.scene_seed(seed, index))
        elements, starts = network(site)
        window, row = float(site["window_m"]), float(site["row_m"])
        origin = np.array([*site["world_origin_m"], 0.0])
        x0 = starts[index]
        # the window's centre in the world frame
        self.center = origin + np.array([x0 + window / 2, 0.5 * row * (int(site["rows"]) - 1),
                                         0.0])
        psi = rng.uniform(-np.pi, np.pi)
        anchor = np.concatenate([rng.uniform(-20.0, 20.0, 2), [0.0]])
        R = fixture._rot_z(psi)
        self.sfm_from_world = _rigid(R, anchor - R @ self.center)
        if index == 0:
            Rm, tm = np.eye(3), np.zeros(3)
        else:
            lo, hi = site["misregistration"]["yaw_deg"]
            Rm = fixture._rot_z(np.deg2rad(rng.choice([-1.0, 1.0]) * rng.uniform(lo, hi)))
            phi = rng.uniform(0.0, 2.0 * np.pi)
            lo, hi = site["misregistration"]["shift_m"]
            tm = rng.uniform(lo, hi) * np.array([np.cos(phi), np.sin(phi), 0.0])
        # wigo of this clip = misregistration @ true chassis-to-world
        self.misregistration = _rigid(Rm, self.center + tm - Rm @ self.center)

        # the drive: camera and odometry times as the benchmark's fixture has them
        self.ms, self.t0 = fixture.frame_ms(cfg, index)
        self.cam_ts = np.asarray(self.ms["camera_front"], np.float64) / 1000.0
        dt = 1.0 / float(cfg["odometry_hz"])
        span = (self.cam_ts[-1] - self.cam_ts[0]) + 0.2
        self.odo_ts = self.cam_ts[0] - 0.1 + 0.007 + dt * np.arange(int(span / dt) + 1)
        lane = rng.integers(int(site["rows"]))
        amp = rng.uniform(*site["sway_m"])
        phase = rng.choice([-1.0, 1.0]) * np.pi / 2 + rng.uniform(-0.3, 0.3)
        mid = 0.5 * (self.cam_ts[0] + self.cam_ts[-1])
        v, w = float(cfg["speed_m_s"]), 2 * np.pi / float(site["sway_period_s"])
        tau = self.odo_ts - mid
        y_dot = amp * w * np.cos(w * tau + phase)
        self.T_world = np.tile(np.eye(4), (len(tau), 1, 1))  # true chassis-to-world
        self.T_world[:, :3, :3] = fixture._rot_z(np.arctan2(y_dot, v))
        self.T_world[:, :3, 3] = origin + np.stack([
            x0 + window / 2 + v * tau,
            row * lane + 2.5 + amp * np.sin(w * tau + phase),
            0.5 + 0.03 * np.sin(3.0 * tau)], -1)
        self.T_cam_world = np.stack([ref_scene.interpolate_pose(self.odo_ts, self.T_world, t)
                                     for t in self.cam_ts])
        ratio = sv_ratio(self.T_cam_world[:, :3, 3])
        if ratio < float(site["min_sv_ratio"]):
            raise RuntimeError(f"clip {index}: chassis track's singular-value ratio {ratio:.2e}")

        # label polylines in network coordinates, before any label fix
        spacing = float(site["vertex_spacing_m"])
        jitter = float(site["end_jitter_m"])
        self.lines, self.element_ids = [], []
        for e, (cls, start, end) in enumerate(elements):
            if not x0 <= 0.5 * (start[0] + end[0]) < x0 + window:
                continue
            d = end - start
            length = np.linalg.norm(d)
            normal = np.array([-d[1], d[0]]) / max(length, 1e-9)
            k = max(2, int(np.ceil(length / spacing)) + 1)
            t = np.linspace(0.0, 1.0, k)
            t[0] += rng.uniform(-jitter, jitter) / length
            t[-1] += rng.uniform(-jitter, jitter) / length
            xy = start + t[:, None] * d + 0.3 * np.sin(np.pi * t)[:, None] * normal
            xy = xy + rng.normal(0.0, rng.choice(site["label_noise_m"]), xy.shape)
            self.lines.append((cls, _snapped(xy)))
            self.element_ids.append(e)

    def label_records(self, offset):
        """map_labels.json's records with the network moved by `offset` [2]
        m: BEV pixels of the clip's SfM frame."""
        half = float(self.cfg["map_size_m"]) / 2
        px = float(self.cfg["densify_m"])
        A = self.sfm_from_world
        out = []
        for cls, xy in self.lines:
            w = np.concatenate([xy + offset, np.zeros((len(xy), 1))], 1)
            w[:, :2] += np.asarray(self.cfg["site"]["world_origin_m"])
            s = w @ A[:3, :3].T + A[:3, 3]
            out.append(fixture._label_record(cls, np.stack([(s[:, 1] + half) / px,
                                                            (s[:, 0] + half) / px], -1)))
        return out


def draw_offset(cfg, seed, draw):
    """[2] m: how far label fix `draw` moves the whole network (draw 0 is the
    clip as written)."""
    fix = cfg["site"]["label_fix_m"]
    rng = np.random.default_rng(fixture.scene_seed(seed, (1 << 21) + int(draw)))
    return np.array([rng.uniform(-1.0, 1.0) * float(fix["along"]),
                     rng.uniform(-1.0, 1.0) * float(fix["across"])])


def write_labels(clip_path, member, cfg, seed, draw=0):
    """Write draw `draw` of a member clip's map_labels.json."""
    text = json.dumps(member.label_records(draw_offset(cfg, seed, draw)))
    with open(os.path.join(clip_path, "maps", "map_labels.json"), "w") as f:
        f.write(text)  # one write: json.dump writes token by token


def ensure_grid(cache_root, cfg):
    """The flat road's height grid (zeros), written once a checkout."""
    path = os.path.join(cache_root, cfg["name"], "images", "vision_road_mlp_ft.npy")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.npy"
        np.save(tmp, np.zeros((fixture.GRID_SIZE, fixture.GRID_SIZE), np.float32))
        os.replace(tmp, path)
    return path


def write_clip(root, cfg, seed, member, images_dir, grid_path):
    """Write a member clip under root; returns its path.  Camera
    directories link into images_dir, the height grid to grid_path."""
    name = f"scene-{member.index:04d}"
    clip = os.path.join(root, name)
    shutil.rmtree(clip, ignore_errors=True)
    os.makedirs(os.path.join(clip, "odometry"))
    os.makedirs(os.path.join(clip, "maps"))
    cams = cfg["cameras"]
    w, h = int(cfg["image_width"]), int(cfg["image_height"])
    fx = float(cfg["focal_px"])
    K = [[fx, 0.0, w / 2 + 16.0], [0.0, fx, h / 2 + 41.0], [0.0, 0.0, 1.0]]
    calib = {}
    for cam, yaw in zip(cams, cfg["camera_yaw_deg"]):
        calib[f"{cam}_2_chassis"] = fixture.cam2chassis(yaw).tolist()
        calib[cam] = {"center_u": K[0][2], "center_v": K[1][2], "distort": [0] * 8,
                      "focal_u": fx, "focal_v": fx, "fov": 70, "image_height": h,
                      "image_width": w, "K": K, "d": [0] * 8}
    ms = member.ms
    with open(os.path.join(clip, "attribute.json"), "w") as f:
        json.dump({"start_time": ms["camera_front"][0], "end_time": ms["camera_front"][-1],
                   "status": "init", "calibration": calib, "unsync": ms, "sync": ms}, f)
    main_yaw = cfg["camera_yaw_deg"][cams.index("camera_front")]
    T_cam = member.sfm_from_world @ member.T_cam_world @ fixture.cam2chassis(main_yaw)
    np.savetxt(os.path.join(clip, "odometry", "scmv_camera_front.txt"),
               fixture._tum(member.cam_ts, T_cam))
    np.savetxt(os.path.join(clip, "odometry", "wigo.txt"),
               fixture._tum(member.odo_ts, member.misregistration @ member.T_world))
    os.symlink(os.path.abspath(grid_path),
               os.path.join(clip, "maps", "vision_road_mlp_ft.npy"))
    write_labels(clip, member, cfg, seed)
    for cam in cams:
        os.symlink(os.path.join(os.path.abspath(images_dir), cam), os.path.join(clip, cam))
    return clip
