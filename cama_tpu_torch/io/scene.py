"""Scene compiler without jax, and the scene's tensors on the device.

A copy of cama_tpu/io/scene.py: the Scene type, the pose chains, the
scene-cache format and key, and `compile_scene`.  The original imports the
clip reader and SE(3) modules, which import jax whenever it is installed;
this one takes them from cama_tpu_torch.io.clip and cama_tpu_torch.se3, the
lifting from cama_tpu_torch.ops.lift, and the point flattening
(flatten_instances, a copy of cama_tpu.ops.lift's) takes MAX_CLS from this
package's ops/raster.py.  Both packages
compile identical scenes and read each other's `.cama_tpu/scene_cache.npz`
(tests/test_torch_pipeline.py).
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from cama_tpu_torch.ops import lift
from cama_tpu_torch.io.clip import ClipReader
from cama_tpu_torch.ops.raster import MAX_CLS
from cama_tpu_torch.se3 import Trajectory, inv_se3

DEFAULT_CAMA_CONFIGS = {
    "result_dir": "maps",
    "camera_list": [
        "camera_front_left", "camera_front", "camera_front_right",
        "camera_rear_left", "camera_rear", "camera_rear_right",
    ],
    "camera_main": "camera_front",
    "height_mlp": "vision_road_mlp_ft.npy",
    "pose_prefix": "scmv",
    "cama_map_file": "map_labels.json",
    "nuscenes_map_file": "map_nuscenes.json",
    # BEV map extent in meters (600 for v2 labels, 300 for v1)
    "map_size_m": 600.0,
    # pre-undistorted frame store (io.frame_cache) and where it lives;
    # fast_decode: half-resolution JPEG decode for cache builds (not
    # byte-identical); frame_cache_budget: writer share of one core
    "frame_cache": True,
    "frame_cache_dir": None,
    "fast_decode": False,
    "frame_cache_budget": None,
    # ground-truth mask store keying (read by the JAX package's metrics)
    "gt_cache_full_hash": False,
    # overlay device program of the JAX package; this package serves every
    # value with its fused kernel
    "raster_kernel": None,
    # persist the compiled scene under {clip}/.cama_tpu (or scene_cache_dir)
    "scene_cache": True,
    "scene_cache_dir": None,
}

OUTPUT_SIZE = (540, 960)  # (h, w)


@dataclass
class Scene:
    clip_path: str
    camera_list: list
    camera_main: str
    output_size: tuple  # (h, w)
    # calibration (host float64)
    K_orig: np.ndarray  # [C, 3, 3]
    K_scaled: np.ndarray  # [C, 3, 3] rescaled to output_size
    d: np.ndarray  # [C, 8]
    image_size: tuple  # (h, w) original
    cam2chassis: np.ndarray  # [C, 4, 4]
    chassis2cam: np.ndarray  # [C, 4, 4]
    # frames
    frame_times: np.ndarray  # [N] float64 seconds (sync, camera_main)
    sync_ms: dict = field(repr=False, default=None)  # sensor -> [N] ms ints
    # label sources -> flattened points; pose chains
    flat: dict = field(default_factory=dict)  # source -> lift.FlatPoints
    traj: dict = field(default_factory=dict)  # source -> se3.Trajectory
    reader: ClipReader = field(repr=False, default=None)
    from_cache: bool = False  # True when served by load_scene_cache

    def image_path(self, camera, index):
        """JPEG of `camera` at row `index` of the sync table."""
        return os.path.join(self.clip_path, camera,
                            f"{self.sync_ms[camera][index]}.jpg")


def build_chassis_trajectory(reader, source, configs=None):
    """chassis2world pose chains: 'cama' is the SfM camera_main poses
    right-multiplied by chassis->camera_main; 'nuscenes' / 'wigo_offset' the
    recentered ego odometry; 'wigo' the raw ego odometry."""
    configs = {**DEFAULT_CAMA_CONFIGS, **(configs or {})}
    tr = Trajectory()
    if source == "cama":
        camera_main = configs["camera_main"]
        chassis2cam_main = reader.extrinsic("chassis", camera_main)
        tr.loadarray(reader.odometry(f"{configs['pose_prefix']}_{camera_main}.txt"))
        tr.right_rotate(chassis2cam_main)
    elif source in ("nuscenes", "wigo_offset"):
        tr.loadarray(reader.odometry("wigo_offset_clip.txt"))
        tr.normalize2center()
    elif source == "wigo":
        tr.loadarray(reader.odometry("wigo.txt"))
    else:
        raise ValueError(f"unknown pose source {source}")
    return tr


def save_scene_cache(scene, path, cache_key=""):
    """Persist the compiled scene (write-then-rename, so a concurrent reader
    never sees a partial file)."""
    payload = {
        "cache_key": np.asarray(cache_key),
        "camera_list": np.asarray(scene.camera_list, dtype=object),
        "camera_main": scene.camera_main,
        "output_size": np.asarray(scene.output_size),
        "K_orig": scene.K_orig, "K_scaled": scene.K_scaled, "d": scene.d,
        "image_size": np.asarray(scene.image_size),
        "cam2chassis": scene.cam2chassis, "chassis2cam": scene.chassis2cam,
        "frame_times": scene.frame_times,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    for src, fp in scene.flat.items():
        payload[f"flat_{src}_points"] = fp.points
        payload[f"flat_{src}_cls"] = fp.cls
        payload[f"flat_{src}_inst"] = fp.inst
        payload[f"flat_{src}_valid"] = fp.valid
        payload[f"flat_{src}_names"] = np.asarray(fp.class_names, dtype=object)
        tr = scene.traj[src]
        payload[f"traj_{src}_T"] = tr.as_transform(True)
        payload[f"traj_{src}_ts"] = tr.timestamps
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        np.savez_compressed(tmp, **payload)
        # savez appends .npz when missing; our tmp has no .npz suffix
        written = tmp if os.path.exists(tmp) else tmp + ".npz"
        os.replace(written, path)
    except BaseException:
        for cand in (tmp, tmp + ".npz"):
            try:
                os.remove(cand)
            except OSError:
                pass
        raise
    return path


def load_scene_cache(path, clip_path):
    """Rebuild a Scene from a cache file (attribute.json is still read for
    image paths and sync tables)."""
    z = np.load(path, allow_pickle=True)
    reader = ClipReader(clip_path)
    flat, traj = {}, {}
    for key in z.files:
        if key.startswith("flat_") and key.endswith("_points"):
            src = key[len("flat_"):-len("_points")]
            flat[src] = lift.FlatPoints(
                z[f"flat_{src}_points"], z[f"flat_{src}_cls"], z[f"flat_{src}_inst"],
                z[f"flat_{src}_valid"], list(z[f"flat_{src}_names"]),
            )
            tr = Trajectory()
            tr.from_absolute_transform(z[f"traj_{src}_T"])
            tr.timestamps = z[f"traj_{src}_ts"]
            traj[src] = tr
    return Scene(
        clip_path=str(clip_path),
        camera_list=list(z["camera_list"]),
        camera_main=str(z["camera_main"]),
        output_size=tuple(int(v) for v in z["output_size"]),
        K_orig=z["K_orig"], K_scaled=z["K_scaled"], d=z["d"],
        image_size=tuple(int(v) for v in z["image_size"]),
        cam2chassis=z["cam2chassis"], chassis2cam=z["chassis2cam"],
        frame_times=z["frame_times"],
        sync_ms={s: list(v) for s, v in reader.attribute["sync"].items()},
        flat=flat, traj=traj, reader=reader, from_cache=True,
    )


def _file_sig(path):
    """Content signature of one input file: (size, sha256 of the first and
    last megabyte)."""
    try:
        st = os.stat(path)
    except OSError:
        return ("absent",)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
        if st.st_size > (2 << 20):
            f.seek(-(1 << 20), 2)
        h.update(f.read(1 << 20))
    return (st.st_size, h.hexdigest())


def _clip_content_sig(clip_path, configs, sources):
    """Signatures of every clip file whose content flows into the compiled
    scene: labels, height grid, odometry, attribute.json."""
    result_dir = configs["result_dir"]
    files = [os.path.join(clip_path, "attribute.json"),
             os.path.join(clip_path, "odometry", "wigo_offset_clip.txt")]
    if "cama" in sources:
        files += [
            os.path.join(clip_path, "odometry",
                         f"{configs['pose_prefix']}_{configs['camera_main']}.txt"),
            os.path.join(clip_path, result_dir, configs["cama_map_file"]),
            os.path.join(clip_path, result_dir, configs["height_mlp"]),
        ]
    if "nuscenes" in sources:
        files.append(os.path.join(clip_path, result_dir,
                                  configs["nuscenes_map_file"]))
    return tuple((os.path.basename(f),) + _file_sig(f) for f in files)


def _scene_cache_key(configs, sources, output_size, pad_multiple, clip_path=None):
    """Compilation parameters and input-content signatures that change the
    cached scene."""
    content = (_clip_content_sig(str(clip_path), configs, sources)
               if clip_path is not None else ())
    return repr((tuple(sorted(sources)), tuple(output_size), int(pad_multiple),
                 float(configs.get("map_size_m", 600.0)),
                 tuple(configs.get("camera_list", ())),
                 configs.get("pose_prefix"), configs.get("cama_map_file"),
                 configs.get("nuscenes_map_file"), content))


def flatten_instances(instances, class_names=None, pad_multiple=1024):
    """(class_name, points[P,3]) list -> lift.FlatPoints padded to a
    multiple; a copy of cama_tpu.ops.lift.flatten_instances.

    Unknown class names are appended to class_names (insertion order kept so
    color lookups stay deterministic)."""
    class_names = list(class_names) if class_names else list(lift.DEFAULT_CLASS_NAMES)
    pts_list, cls_list, inst_list = [], [], []
    for i, (cls, pts) in enumerate(instances):
        if cls not in class_names:
            class_names.append(cls)
            if len(class_names) > MAX_CLS:
                # the rasters pack class ids modulo MAX_CLS; more classes
                # would silently alias paint priorities and colors
                raise ValueError(
                    f"more than {MAX_CLS} map classes ({class_names}) — the "
                    f"overlay packing stride cannot represent class id "
                    f"{len(class_names) - 1}"
                )
        pts = np.asarray(pts, dtype=np.float32).reshape(-1, 3)
        pts_list.append(pts)
        cls_list.append(np.full(len(pts), class_names.index(cls), dtype=np.int32))
        inst_list.append(np.full(len(pts), i, dtype=np.int32))
    n = sum(len(p) for p in pts_list)
    npad = max(pad_multiple, -(-n // pad_multiple) * pad_multiple) if n else pad_multiple
    points = np.zeros((npad, 3), dtype=np.float32)
    cls = np.zeros(npad, dtype=np.int32)
    inst = np.full(npad, -1, dtype=np.int32)
    valid = np.zeros(npad, dtype=bool)
    if n:
        points[:n] = np.concatenate(pts_list)
        cls[:n] = np.concatenate(cls_list)
        inst[:n] = np.concatenate(inst_list)
    valid[:n] = True
    return lift.FlatPoints(points, cls, inst, valid, class_names)


def compile_scene(clip_path, configs=None, sources=("cama", "nuscenes"),
                  output_size=OUTPUT_SIZE, pad_multiple=1024, cache=None):
    """Clip directory -> Scene (host arrays), served from `cache` when its
    key matches."""
    configs = {**DEFAULT_CAMA_CONFIGS, **(configs or {})}
    key = _scene_cache_key(configs, sources, output_size, pad_multiple,
                           clip_path=clip_path)
    if cache and os.path.exists(cache):
        try:
            stored = np.load(cache, allow_pickle=True)
            if str(stored.get("cache_key", "")) == key:
                return load_scene_cache(cache, clip_path)
        except Exception:  # corrupt or truncated cache: recompile, overwrite
            pass
    reader = ClipReader(clip_path)
    camera_list = configs["camera_list"]
    C = len(camera_list)
    K_orig = np.zeros((C, 3, 3))
    K_scaled = np.zeros((C, 3, 3))
    d = np.zeros((C, 8))
    cam2chassis = np.zeros((C, 4, 4))
    chassis2cam = np.zeros((C, 4, 4))
    img_h = img_w = None
    for i, cam in enumerate(camera_list):
        intr = reader.intrinsics(cam)
        K_orig[i] = intr["K"]
        d[i, : len(intr["d"])] = intr["d"]
        img_w, img_h = intr["width"], intr["height"]
        K = intr["K"].copy()  # reference K rescale to the output size
        K[0, :] = K[0, :] * output_size[1] / img_w
        K[1, :] = K[1, :] * output_size[0] / img_h
        K_scaled[i] = K
        chassis2cam[i] = reader.extrinsic("chassis", cam)
        cam2chassis[i] = inv_se3(chassis2cam[i])

    result_dir = configs["result_dir"]
    flat, traj = {}, {}
    if "cama" in sources:
        label_path = os.path.join(clip_path, result_dir, configs["cama_map_file"])
        if os.path.exists(label_path):
            labels = reader.map_json(result_dir, configs["cama_map_file"])
            grid = reader.height_grid(result_dir, configs["height_mlp"])
            m = float(configs.get("map_size_m", 600.0))
            instances = lift.lift_cama_instances(labels, grid, map_width=m, map_height=m)
            flat["cama"] = flatten_instances(instances, pad_multiple=pad_multiple)
            traj["cama"] = build_chassis_trajectory(reader, "cama", configs)
    if "nuscenes" in sources:
        label_path = os.path.join(clip_path, result_dir, configs["nuscenes_map_file"])
        if os.path.exists(label_path):
            labels = reader.map_json(result_dir, configs["nuscenes_map_file"])
            instances = lift.lift_nuscenes_instances(labels)
            flat["nuscenes"] = flatten_instances(instances, pad_multiple=pad_multiple)
            traj["nuscenes"] = build_chassis_trajectory(reader, "nuscenes", configs)

    scene = Scene(
        clip_path=str(clip_path),
        camera_list=list(camera_list),
        camera_main=configs["camera_main"],
        output_size=tuple(output_size),
        K_orig=K_orig,
        K_scaled=K_scaled,
        d=d,
        image_size=(img_h, img_w),
        cam2chassis=cam2chassis,
        chassis2cam=chassis2cam,
        frame_times=reader.sensor_timestamps(configs["camera_main"], sync=True),
        sync_ms={s: list(v) for s, v in reader.attribute["sync"].items()},
        flat=flat,
        traj=traj,
        reader=reader,
    )
    if cache:
        try:
            save_scene_cache(scene, cache, cache_key=key)
        except OSError:
            pass  # read-only clip mount: run uncached rather than fail
    return scene


class SceneTensors(NamedTuple):
    """One label source of a compiled scene, on the device.

    points [P, 3] f32, cls [P] i32 and valid [P] bool are the arrays the JAX
    package's Scene.device_points uploads; A [F', 4, 4] and B [F', C, 3, 4]
    f32 and frame_valid [F'] bool are the host float64 frame matrices cast
    to float32 and padded to F' = a multiple of the frame chunk (pad frames
    carry identity A and frame_valid False)."""

    points: torch.Tensor
    cls: torch.Tensor
    valid: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    frame_valid: torch.Tensor


def pad_frames(fm, chunk):
    """(A, B, frame_valid) of FrameMatrices as float32/bool host arrays,
    padded to a multiple of `chunk` frames with identity A (keeps the pad
    matrices invertible) and frame_valid False."""
    F = len(fm.frame_indices)
    Fp = -(-F // chunk) * chunk
    A = np.tile(np.eye(4, dtype=np.float32), (Fp, 1, 1))
    A[:F] = fm.A.astype(np.float32)
    B = np.zeros((Fp,) + fm.B.shape[1:], np.float32)
    B[:F] = fm.B.astype(np.float32)
    fv = np.zeros(Fp, bool)
    fv[:F] = fm.frame_valid
    return A, B, fv


def scene_to_torch(scene, source, device, fm, chunk=1):
    """SceneTensors of `source` on `device`; `fm` is the source's
    FrameMatrices (ops.geometry.compose_frame_matrices)."""
    fp = scene.flat[source]
    A, B, fv = pad_frames(fm, chunk)
    return SceneTensors(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (fp.points, fp.cls, fp.valid, A, B, fv)))
