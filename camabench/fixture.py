"""The benchmark's own clip generator: scenes in CAMA's on-disk clip format,
made from a configuration file and a seed.

A frozen copy of the program's synthetic fixture (io/fixture.py's
make_fixture_clip), changed where the benchmark needs it:

- the seed draws the content: the lateral sway of the trajectory and its
  phase, a rigid offset of every label polyline and the phase of the BEV
  height grid.  Segment lengths, point counts and frame times do not
  depend on it, so every seed gives the same amount of work;
- the ego odometry runs at its own rate (`odometry_hz`), off the camera
  times, so serving the nuScenes labels interpolates poses;
- camera images depend on the configuration and the scene's index only.
  They are written once per checkout under `.cache/<config>/images` and
  linked into each seed's clip, so the per-clip frame store, which is keyed
  by calibration and frame times, is filled once as well;
- ground-truth instance masks are drawn by NumPy from the reference's own
  lifting and projection (not by the program), shifted by a seeded
  offset of a few pixels, with seeded lane markings left out and a stop
  line added.

Nothing here imports the program under test.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from camabench.reference import scene as ref_scene

T0_MS = 1_600_000_000_000
GRID_SIZE = 1200
LANE_Y = (-243.0, -240.0, -237.0)
EDGE_Y = (-246.5, -233.5)
CROSSWALK_X = (-231.0, -230.2, -229.4)


def scene_seed(seed, index):
    """The seed of scene `index` of a run (several scenes a run)."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])


def _workers():
    return max(1, min(8, os.cpu_count() or 1))


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros(np.shape(yaw) + (3, 3))
    R[..., 0, 0], R[..., 0, 1], R[..., 1, 0], R[..., 1, 1], R[..., 2, 2] = c, -s, s, c, 1.0
    return R


def cam2chassis(yaw_deg):
    """Camera (z forward, x right, y down) pose in the chassis (x forward,
    y left, z up): 1.5 m ahead of the centre along its yaw, 1.6 m up."""
    yaw = np.deg2rad(yaw_deg)
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    T = np.eye(4)
    T[:3, :3] = _rot_z(yaw) @ base
    T[:3, 3] = _rot_z(yaw) @ np.array([1.5, 0.0, 0.0]) + np.array([0.0, 0.0, 1.6])
    return T


class Trajectory:
    """Chassis-to-world poses of a smooth drive along +x near (-270, -240)."""

    def __init__(self, cfg, rng):
        self.v = float(cfg["speed_m_s"])
        self.amp = rng.uniform(1.0, 2.0)
        self.phase = rng.uniform(0.0, 2 * np.pi)

    def __call__(self, t):
        t = np.atleast_1d(np.asarray(t, np.float64))
        w = 0.35
        x = -270.0 + self.v * t
        y = -240.0 + self.amp * np.sin(w * t + self.phase)
        z = 0.5 + 0.05 * np.sin(0.2 * t)
        yaw = np.arctan2(self.amp * w * np.cos(w * t + self.phase), self.v)
        pitch = 0.01 * np.sin(0.15 * t)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.zeros((len(t), 3, 3))
        Ry[:, 0, 0], Ry[:, 0, 2], Ry[:, 2, 0], Ry[:, 2, 2], Ry[:, 1, 1] = cp, sp, -sp, cp, 1.0
        T = np.tile(np.eye(4), (len(t), 1, 1))
        T[:, :3, :3] = _rot_z(yaw) @ Ry
        T[:, :3, 3] = np.stack([x, y, z], -1)
        return T


def matrix_to_quat(R):
    """Rotations [N, 3, 3] -> (x, y, z, w) unit quaternions, w >= 0."""
    R = np.asarray(R)
    w = np.sqrt(np.maximum(0.0, 1 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2])) / 2
    x = np.sqrt(np.maximum(0.0, 1 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2])) / 2
    y = np.sqrt(np.maximum(0.0, 1 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2])) / 2
    z = np.sqrt(np.maximum(0.0, 1 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2])) / 2
    x = np.copysign(x, R[:, 2, 1] - R[:, 1, 2])
    y = np.copysign(y, R[:, 0, 2] - R[:, 2, 0])
    z = np.copysign(z, R[:, 1, 0] - R[:, 0, 1])
    q = np.stack([x, y, z, w], -1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _tum(ts_s, T):
    return np.concatenate([ts_s[:, None], T[:, :3, 3], matrix_to_quat(T[:, :3, :3])], 1)


def _segment_counts_stable(poly, step):
    """True when every segment's point count int(length / step) is the same
    in float32 (the label files' arithmetic) and float64, with room."""
    p32 = np.asarray(poly, np.float32)
    l32 = np.linalg.norm(p32[1:] - p32[:-1], axis=-1).astype(np.float32)
    n32 = (l32 / np.float32(step)).astype(np.int64)
    q = np.linalg.norm(np.diff(np.asarray(poly, np.float64), axis=0), axis=-1) / step
    frac = q - np.floor(q)
    return bool(np.all(n32 == np.floor(q)) and np.all((frac > 1e-3) & (frac < 1 - 1e-3)))


def world_polylines(cfg, rng):
    """[(class, vertices [N, 2] world metres)] with a seeded rigid offset per
    line and a common longitudinal shift; lengths do not depend on the
    seed."""
    span = cfg["label_span_m"]
    dx = rng.uniform(-2.0, 2.0)
    # segment lengths 0.00366 m past a multiple of the densify step, so
    # that no point count sits on a rounding edge
    xs = np.linspace(span[0], span[1] + 0.0293, 9) + dx
    lines = []
    for wy in LANE_Y:
        off = rng.uniform(-0.3, 0.3)
        lines.append(("lane_marking", np.stack(
            [xs, np.full_like(xs, wy + off) + 0.4 * np.sin(0.08 * (xs - dx))], -1)))
    for wy in EDGE_Y:
        off = rng.uniform(-0.3, 0.3)
        lines.append(("Road_teeth", np.stack([xs, np.full_like(xs, wy + off)], -1)))
    for wx in CROSSWALK_X:
        ys = np.linspace(-246.0, -233.9889, 4) + rng.uniform(-0.3, 0.3)
        lines.append(("Crosswalk_Line", np.stack([np.full_like(ys, wx + dx), ys], -1)))
    return lines


def _label_record(cls, data):
    return {"attrs": {"type": cls}, "data": np.asarray(data, np.float64).tolist(),
            "id": -1, "luid": "auto", "point_attrs": [[] for _ in range(len(data))],
            "shape_type": "polyline", "struct_type": "parsing", "track_id": -1}


def synth_image(cam_index, frame, width, height):
    """Deterministic patterned BGR image of one camera and frame."""
    u = np.arange(width, dtype=np.float32)[None, :]
    v = np.arange(height, dtype=np.float32)[:, None]
    c = cam_index
    b = 127 + 80 * np.sin(u / 97.0 + c) * np.cos(v / 71.0 + frame * 0.3)
    g = 127 + 80 * np.sin(u / 53.0 - frame * 0.2) * np.cos(v / 89.0 + c)
    r = 127 + 80 * np.sin((u + v) / 127.0 + c + frame * 0.1)
    img = np.stack(np.broadcast_arrays(b, g, r), -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def frame_ms(cfg, scene_index):
    """{camera: [N] ms}: camera c fires 2c ms after camera_front's tick."""
    t0 = T0_MS + 100_000 * int(scene_index)
    n, hz = int(cfg["frames_per_scene"]), float(cfg["camera_hz"])
    return {cam: [t0 + round(1000 * k / hz) + 2 * i for k in range(n)]
            for i, cam in enumerate(cfg["cameras"])}, t0


def ensure_images(cache_root, cfg, scene_index):
    """Directory of the scene's camera JPEGs, written once per checkout."""
    import cv2

    out = os.path.join(cache_root, cfg["name"], "images", f"scene-{scene_index:04d}")
    done = os.path.join(out, ".complete")
    if os.path.exists(done):
        return out
    shutil.rmtree(out, ignore_errors=True)
    ms, _ = frame_ms(cfg, scene_index)
    w, h = int(cfg["image_width"]), int(cfg["image_height"])
    jobs = []
    for i, cam in enumerate(cfg["cameras"]):
        os.makedirs(os.path.join(out, cam), exist_ok=True)
        jobs += [(i, cam, k, t) for k, t in enumerate(ms[cam])]

    def one(job):
        i, cam, k, t = job
        img = synth_image(i, k + 1000 * scene_index, w, h)
        if not cv2.imwrite(os.path.join(out, cam, f"{t}.jpg"), img):
            raise OSError(f"could not write {cam}/{t}.jpg")

    with ThreadPoolExecutor(_workers()) as pool:
        list(pool.map(one, jobs))
    open(done, "w").close()
    return out


class _Geometry:
    """What a scene's seed fixes besides its labels: the trajectory, the
    frame and odometry times, and the random stream the labels are drawn
    from after the height grid's phase."""

    def __init__(self, cfg, seed, scene_index):
        self.rng = np.random.default_rng(scene_seed(seed, scene_index))
        self.traj = Trajectory(cfg, self.rng)
        self.ms, self.t0 = frame_ms(cfg, scene_index)
        main = cfg["cameras"].index("camera_front")
        self.main_yaw = cfg["camera_yaw_deg"][main]
        self.cam_ts = np.asarray(self.ms["camera_front"], np.float64) / 1000.0
        # ego odometry at its own rate, offset so that the middle row is at 0
        dt = 1.0 / float(cfg["odometry_hz"])
        span = (self.cam_ts[-1] - self.cam_ts[0]) + 0.2
        self.odo_ts = self.cam_ts[0] - 0.1 + 0.007 + dt * np.arange(int(span / dt) + 1)
        T_odo = self.traj(self.odo_ts - self.t0 / 1000.0)
        self.origin = T_odo[len(T_odo) // 2, :3, 3].copy()
        self.T_off = T_odo.copy()
        self.T_off[:, :3, 3] -= self.origin
        self.grid_phase = self.rng.uniform(0.0, 2 * np.pi, 2).astype(np.float32)


def label_records(cfg, seed, scene_index, draw=0):
    """{label file name: records} of one draw of a scene's labels.  Draw 0
    is the clip as written; each later draw (a label fix) moves every
    polyline by a fresh seeded offset and keeps every segment's length, so
    the point counts do not change."""
    g = _Geometry(cfg, seed, scene_index)
    rng = g.rng if draw == 0 else np.random.default_rng([scene_seed(seed, scene_index),
                                                          int(draw)])
    half = float(cfg["map_size_m"]) / 2
    step = float(cfg["densify_m"])
    centre_inv = ref_scene.rigid_inverse(g.T_off[len(g.T_off) // 2])
    for _ in range(100):
        lines = world_polylines(cfg, rng)
        cama = [(cls, np.stack([(p[:, 1] + half) / step, (p[:, 0] + half) / step], -1))
                for cls, p in lines]
        nusc = []
        for cls, p in lines:
            ph = np.concatenate([p, np.zeros((len(p), 1)), np.ones((len(p), 1))], 1)
            ph[:, :3] -= g.origin
            nusc.append((cls, (ph @ centre_inv.T)[:, :2]))
        if all(_segment_counts_stable(p, step) for _, p in cama + nusc):
            break
    else:
        raise RuntimeError("no label draw with stable segment counts")
    out = {}
    if "cama" in cfg["label_sources"]:
        out["map_labels.json"] = [_label_record(c, p) for c, p in cama]
    if "nuscenes" in cfg["label_sources"]:
        out["map_nuscenes.json"] = [_label_record(c, p) for c, p in nusc]
    return out


def write_labels(clip, cfg, seed, scene_index, draw=0):
    """Write draw `draw` of the scene's label files into the clip."""
    for name, records in label_records(cfg, seed, scene_index, draw).items():
        with open(os.path.join(clip, "maps", name), "w") as f:
            json.dump(records, f)


def write_clip(root, cfg, seed, scene_index, images_dir=None):
    """Write scene `scene_index` of config `cfg` for `seed` under root;
    returns the clip path.  Camera directories link into images_dir."""
    g = _Geometry(cfg, seed, scene_index)
    name = f"scene-{scene_index:04d}"
    clip = os.path.join(root, name)
    shutil.rmtree(clip, ignore_errors=True)
    os.makedirs(os.path.join(clip, "odometry"))
    os.makedirs(os.path.join(clip, "maps"))
    ms = g.ms
    cams = cfg["cameras"]
    w, h = int(cfg["image_width"]), int(cfg["image_height"])
    fx = float(cfg["focal_px"])
    K = [[fx, 0.0, w / 2 + 16.0], [0.0, fx, h / 2 + 41.0], [0.0, 0.0, 1.0]]
    calib = {}
    for cam, yaw in zip(cams, cfg["camera_yaw_deg"]):
        calib[f"{cam}_2_chassis"] = cam2chassis(yaw).tolist()
        calib[cam] = {"center_u": K[0][2], "center_v": K[1][2], "distort": [0] * 8,
                      "focal_u": fx, "focal_v": fx, "fov": 70, "image_height": h,
                      "image_width": w, "K": K, "d": [0] * 8}
    with open(os.path.join(clip, "attribute.json"), "w") as f:
        json.dump({"start_time": ms["camera_front"][0], "end_time": ms["camera_front"][-1],
                   "status": "init", "calibration": calib, "unsync": ms, "sync": ms}, f)

    # SfM poses of camera_front at its frame times
    T_cam = g.traj(g.cam_ts - g.t0 / 1000.0) @ cam2chassis(g.main_yaw)
    np.savetxt(os.path.join(clip, "odometry", "scmv_camera_front.txt"), _tum(g.cam_ts, T_cam))
    np.savetxt(os.path.join(clip, "odometry", "wigo_offset_clip.txt"), _tum(g.odo_ts, g.T_off))

    r = np.arange(GRID_SIZE, dtype=np.float32)
    pr, pc = g.grid_phase
    grid = (0.25 * np.sin(r[:, None] / 37.0 + pr) * np.cos(r[None, :] / 53.0 + pc)).astype(np.float32)
    np.save(os.path.join(clip, "maps", "vision_road_mlp_ft.npy"), grid)
    write_labels(clip, cfg, seed, scene_index)
    if images_dir is not None:
        for cam in cams:
            os.symlink(os.path.join(os.path.abspath(images_dir), cam), os.path.join(clip, cam))
    return clip


DISC3 = np.array([(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4)
                  if dy * dy + dx * dx <= 10], np.int64)


def write_gt_masks(clip, cfg, seed, gt):
    """lane_ins_<camera>/<ms>.png uint16 instance masks at the source
    resolution for every served frame of the CAMA labels: each instance's
    points projected at float64 and drawn as discs of radius 3, shifted by
    a seeded offset of gt["shift_px"] = [lo, hi] pixels along each axis,
    either way (an annotation error wider than the disc, so that every
    seed's SRE is well above 0); gt["drop_instances"] seeded lane markings
    are left out and a stop line the map lacks is added, so that neither
    precision nor recall is 1."""
    import cv2

    rng = np.random.default_rng(scene_seed(seed, 1 << 20))
    lo, hi = gt["shift_px"]
    shift = rng.uniform(lo, hi, 2) * rng.choice([-1.0, 1.0], 2)
    data = ref_scene.load_clip(clip, cfg["cameras"],
                               (cfg["output_height"], cfg["output_width"]), ("cama",),
                               float(cfg["map_size_m"]))
    with open(os.path.join(clip, "maps", "map_labels.json")) as f:
        labels = json.load(f)
    grid = np.load(os.path.join(clip, "maps", "vision_road_mlp_ft.npy"))
    lanes = [i for i, inst in enumerate(labels) if inst["attrs"]["type"] == "lane_marking"]
    drop = set(rng.choice(lanes, int(gt["drop_instances"]), replace=False).tolist())
    # a stop line the map does not hold, across the road ahead
    half, step = float(cfg["map_size_m"]) / 2, float(cfg["densify_m"])
    x = -255.0 + rng.uniform(-3.0, 3.0)
    extra = {"attrs": {"type": "Stop_Line"},
             "data": [[(-246.0 + half) / step, (x + half) / step],
                      [(-234.0 + half) / step, (x + half) / step]]}
    pts, ids = [], []
    for i, inst in enumerate(labels + [extra]):
        if i in drop:
            continue
        p, _ = ref_scene.lift_cama([inst], grid, float(cfg["map_size_m"]))
        pts.append(p)
        ids.append(np.full(len(p), i + 1, np.int64))
    pts, ids = np.concatenate(pts), np.concatenate(ids)
    from camabench.reference.render import project

    h, w = data.image_size
    for cam in cfg["cameras"]:
        os.makedirs(os.path.join(clip, f"lane_ins_{cam}"), exist_ok=True)

    def one(item):
        idx, pose = item
        proj = project(pts, pose, data.chassis2cam, data.K_orig, (h, w), cfg["crop_m"])
        for c, cam in enumerate(cfg["cameras"]):
            v, u, keep = proj[c]
            sel = np.flatnonzero(keep)
            py = np.floor(v[sel] + shift[1]).astype(np.int64)[:, None] + DISC3[None, :, 0]
            px = np.floor(u[sel] + shift[0]).astype(np.int64)[:, None] + DISC3[None, :, 1]
            ok = (py >= 0) & (py < h) & (px >= 0) & (px < w)
            img = np.zeros(h * w, np.uint16)
            img[(py * w + px)[ok]] = np.broadcast_to(ids[sel][:, None], py.shape)[ok]
            path = os.path.join(clip, f"lane_ins_{cam}", f"{data.sync_ms[cam][idx]}.png")
            if not cv2.imwrite(path, img.reshape(h, w)):
                raise OSError(f"could not write {path}")

    with ThreadPoolExecutor(_workers()) as pool:
        list(pool.map(one, ref_scene.served_frames(data, "cama")))
