"""LiDAR point aggregation with reconstructed poses: a clip's sweeps, each
through its pose chain (chassis2world at the sweep's time, SLERP between
the bracketing poses, times the lidar->chassis extrinsic), merged into one
world-frame cloud, optionally one point per voxel.

The port of cama_tpu/aggregate/lidar.py.  The sweeps are padded into one
[F, N, 3] float32 tensor with a validity mask and the poses composed on
the host in float64; the transform runs on the device as one batched f32
product (`_transform_points`), or as its NumPy f32 mirror
(`_transform_points_host`, backend 'host').  The JAX package's 'auto'
backend runs small clouds on the host to dodge the TPU's compile wall;
PyTorch runs eagerly with no such wall, so here 'auto' is 'device'.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from cama_tpu_torch.io.clip import ClipReader
from cama_tpu_torch.io.scene import DEFAULT_CAMA_CONFIGS, build_chassis_trajectory
from cama_tpu_torch.pipeline import resolve_device
from cama_tpu_torch.se3 import apply_seek, seek_indices

BACKENDS = ("auto", "host", "device")


@contextlib.contextmanager
def full_f32_matmul():
    """float32 products at full float32 precision (no TF32 on the card) for
    the duration: the JAX package asks for Precision.HIGHEST, and sub-metre
    geometry cannot take TF32's 10-bit mantissa."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _transform_points(T, pts, valid):
    """[F, 4, 4] x [F, N, 3] -> [F, N, 3] world points, NaN where `valid`
    [F, N] is False; float32 on the tensors' device."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    with full_f32_matmul():
        out = ph @ T[:, :3, :].transpose(1, 2)
    return torch.where(valid[..., None], out, torch.nan)


def _transform_points_host(T, pts, valid):
    """NumPy f32 mirror of _transform_points (the 'host' backend): the same
    f32 dtypes, the 4-term contraction in another rounding order."""
    ph = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
    out = np.einsum("fij,fnj->fni", T[:, :3, :].astype(np.float32), ph,
                    dtype=np.float32)
    return np.where(valid[..., None], out, np.float32(np.nan))


def voxel_downsample(points, voxel):
    """Keep one point per voxel (the first in input order), on the host.
    Voxel keys are quantized in float64 and kept as int64: UTM-scale inputs
    cast to f32 would alias voxels (f32 spacing ~0.5 m at 1e6 m).  The
    JAX package's np.unique(axis=0, return_index=True), as one stable
    lexsort of the keys (the first of each run of equal keys is the first
    in input order), several times faster on millions of points."""
    pts = np.asarray(points)
    q = np.floor(pts.astype(np.float64) / voxel).astype(np.int64)
    order = np.lexsort(q.T[::-1])
    qs = q[order]
    first = np.ones(len(q), bool)
    first[1:] = (qs[1:] != qs[:-1]).any(axis=1)
    return pts[np.sort(order[first])]


def aggregate_lidar(clip_path, pose_source="cama", configs=None, voxel=None,
                    every=1, t_max_diff=0.5, deskewed=False, max_frames=None,
                    with_intensity=False, backend="auto", device="cuda"):
    """Aggregate a clip's LiDAR sweeps into one world-frame cloud.

    Args:
        pose_source: 'cama' (the SfM reconstructed chain), 'wigo' (raw ego
                     odometry, UTM frame) or 'wigo_offset'.
        voxel: optional voxel size in meters for downsampling.
        every: take every k-th sweep.
        backend: 'auto' and 'device' run the transform on `device`; 'host'
                 runs its NumPy mirror.
        device: 'cuda' (default; raises without a card) or 'cpu'.
    Returns [N, 3] float64 world points (or [N, 4] with intensity).
    """
    if backend not in BACKENDS:
        raise ValueError(f"aggregate_lidar backend {backend!r} not in {BACKENDS}")
    dev = None if backend == "host" else resolve_device(device)
    configs = {**DEFAULT_CAMA_CONFIGS, **(configs or {})}
    reader = ClipReader(clip_path)
    traj = build_chassis_trajectory(reader, pose_source, configs)
    T_lidar2chassis = reader.extrinsic("lidar_top", "chassis")

    frames, times = [], []
    for i, (ts, pc) in enumerate(reader.iter_lidar(deskewed=deskewed)):
        if i % every:
            continue
        frames.append(pc)
        times.append(ts)
        if max_frames and len(frames) >= max_frames:
            break
    if not frames:
        return np.zeros((0, 3), np.float32)

    idx = seek_indices(traj.timestamps[:, 0], np.asarray(times), t_max_diff, interpolate=True)
    chassis2world = apply_seek(traj.as_transform(True), idx)
    ok = idx["valid"]
    T = (chassis2world @ T_lidar2chassis)[ok]
    frames = [f for f, o in zip(frames, ok) if o]
    if not frames:
        return np.zeros((0, 3), np.float32)

    n_max = max(len(f) for f in frames)
    F = len(frames)
    pts = np.zeros((F, n_max, 3), np.float32)
    inten = np.zeros((F, n_max), np.float32)
    valid = np.zeros((F, n_max), bool)
    for i, f in enumerate(frames):
        pts[i, : len(f)] = f[:, :3]
        inten[i, : len(f)] = f[:, 3] if f.shape[1] > 3 else 0
        valid[i, : len(f)] = True

    # recenter before the float32 transform: 'wigo' poses live in a global
    # UTM frame where |t| ~ 1e5-1e6 m would crush world-point precision to
    # centimeters in f32; the mean translation is added back in float64
    center = T[:, :3, 3].mean(axis=0)
    T_local = T.copy()
    T_local[:, :3, 3] -= center
    if dev is None:
        world = _transform_points_host(T_local.astype(np.float32), pts, valid)
    else:
        world = _transform_points(
            torch.from_numpy(T_local.astype(np.float32)).to(dev),
            torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev),
        ).cpu().numpy()
    flat = world.astype(np.float64).reshape(-1, 3) + center
    keep = ~np.isnan(flat[:, 0])
    out = flat[keep]
    inten_flat = inten.reshape(-1)[keep]
    if voxel:
        out = voxel_downsample(out, voxel)
        with_intensity = False  # intensity dropped by dedup
    if with_intensity:
        return np.concatenate([out, inten_flat[:, None]], axis=1)
    return out


def save_pcd(path, points, colors=None):
    """Write an ASCII PCD v0.7.  float64 inputs are written as SIZE 8
    doubles: site and LiDAR points are UTM-scale world coordinates, where a
    float32 cast quantizes by ~0.5 m."""
    points = np.asarray(points)
    f64 = points.dtype == np.float64
    points = points.astype(np.float64 if f64 else np.float32)
    fsz = "8" if f64 else "4"
    n = len(points)
    with open(path, "w") as f:
        fields = "x y z" + (" rgb" if colors is not None else "")
        sizes = f"{fsz} {fsz} {fsz}" + (" 4" if colors is not None else "")
        types = "F F F" + (" U" if colors is not None else "")
        counts = "1 1 1" + (" 1" if colors is not None else "")
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            f"VERSION 0.7\nFIELDS {fields}\nSIZE {sizes}\nTYPE {types}\n"
            f"COUNT {counts}\nWIDTH {n}\nHEIGHT 1\n"
            "VIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA ascii\n"
        )
        if colors is not None:
            colors = np.asarray(colors, dtype=np.uint32)
            rgb = (colors[:, 0] << 16) | (colors[:, 1] << 8) | colors[:, 2]
            for (x, y, z), c in zip(points, rgb):
                f.write(f"{x:.6f} {y:.6f} {z:.6f} {c}\n")
        else:
            for x, y, z in points:
                f.write(f"{x:.6f} {y:.6f} {z:.6f}\n")
    return path


def save_xyz(path, points):
    """%.3f xyz text."""
    np.savetxt(path, np.asarray(points)[:, :3], fmt="%.3f")
    return path


def main(argv=None):
    """cama-tpu-torch-lidar: aggregate a clip's LiDAR sweeps into one cloud."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Aggregate a clip's LiDAR sweeps with reconstructed poses"
    )
    parser.add_argument("--clip", required=True)
    parser.add_argument("--out", required=True, help=".pcd or .xyz output path")
    parser.add_argument("--pose-source", default="cama",
                        choices=["cama", "wigo", "wigo_offset"])
    parser.add_argument("--voxel", type=float, default=None)
    parser.add_argument("--every", type=int, default=1)
    parser.add_argument("--deskewed", action="store_true")
    parser.add_argument("--backend", default="auto", choices=list(BACKENDS),
                        help="'host' runs the NumPy transform mirror; 'auto' "
                             "and 'device' run it on --device")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    pts = aggregate_lidar(args.clip, pose_source=args.pose_source, voxel=args.voxel,
                          every=args.every, deskewed=args.deskewed,
                          backend=args.backend, device=args.device)
    if args.out.endswith(".xyz"):
        save_xyz(args.out, pts)
    else:
        save_pcd(args.out, pts)
    print(f"{len(pts)} points -> {args.out}")


if __name__ == "__main__":
    main()
