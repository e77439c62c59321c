"""KITTI-style pose trajectory evaluation (RTE/RRE/ATE/RPE/ITE/IRE + per-axis
Euler errors): a copy of cama_tpu/eval/pose_metrics.py, which imports jax
through cama_tpu.se3.  Host NumPy float64 and matplotlib; nothing here runs
on a device.  The same results as the original on the same arrays
(tests/test_torch_se3_pose.py, against the JAX package and against
tests/golden/pose_eval.npz).  Semantics (including the reference
evaluator's quirks):

  * greedy timestamp association ordered by (|dt|, t_gt, t_pred)
    (pose_evaluator.py:76-104)
  * `scale` pre-multiplies only columns 1:3 (x, y!) of the pred TUM array
    (pose_evaluator.py:163)
  * segment set 100..800 m with step 10 frames and 10 FPS assumed speed
  * alignment modes: None / "scale" / "scale_7dof" / "7dof" / "6dof"
    (scale_7dof scales but does not apply the rigid alignment)
  * ATE = RMSE over translation distances; RPE = mean (not RMSE)

All math is float64 on host: trajectories are tiny (10^3-10^4 poses), and the
reference's np.linalg.inv chains are reproduced exactly.
"""
from __future__ import annotations

import numpy as np

from cama_tpu_torch.se3 import as_euler, matrix_to_quat, quat_to_matrix


def associate(first_keys, second_keys, max_t_diff, offset=0.0):
    """Greedy closest-pair timestamp association (pose_evaluator.py:76-104).

    Returns list of (a, b) pairs sorted by a.
    """
    a = np.asarray(sorted(first_keys), dtype=np.float64)
    b = np.asarray(sorted(second_keys), dtype=np.float64)
    # candidate pairs: |a - (b + offset)| < max_t_diff, found by windowing b
    # around each a instead of the reference's full cross product
    bo = b + offset
    lo = np.searchsorted(bo, a - max_t_diff, side="left")
    hi = np.searchsorted(bo, a + max_t_diff, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return []
    # flatten the per-a candidate windows without a Python double loop
    ai = np.repeat(np.arange(len(a)), counts)
    bi = np.repeat(lo, counts) + (
        np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    )
    strict = np.abs(a[ai] - bo[bi]) < max_t_diff  # window is closed, ref is strict
    ai, bi = ai[strict], bi[strict]
    if len(ai) == 0:
        return []
    diff = np.abs(a[ai] - bo[bi])
    order = np.lexsort((b[bi], a[ai], diff))  # sort by (diff, a, b)
    used_a, used_b, matches = set(), set(), []
    for k in order:
        i, j = int(ai[k]), int(bi[k])
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        matches.append((float(a[i]), float(b[j])))
    matches.sort()
    return matches


def umeyama_alignment(x, y, with_scale=False):
    """Umeyama least-squares Sim(3) (pose_evaluator.py:106-154).
    x, y: [m, n] (dimension x points). Returns (R, t, c)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape:
        raise AssertionError("x.shape not equal to y.shape")
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = 1.0 / n * (np.linalg.norm(x - mean_x[:, None]) ** 2)
    cov_xy = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov_xy)
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[m - 1, m - 1] = -1
    r = u @ s @ v
    c = 1 / sigma_x * np.trace(np.diag(d) @ s) if with_scale else 1.0
    t = mean_y - c * (r @ mean_x)
    return r, t, c


def _tum_rows_to_transforms(rows):
    """[M, 7] (x y z qx qy qz qw) -> [M, 4, 4]."""
    rows = np.asarray(rows, dtype=np.float64)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :3] = quat_to_matrix(rows[:, 3:7])
    T[:, :3, 3] = rows[:, :3]
    return T


def _rotation_error(pose_error):
    """Batched trace-based geodesic angle (pose_evaluator.py:211-223)."""
    d = 0.5 * (pose_error[..., 0, 0] + pose_error[..., 1, 1] + pose_error[..., 2, 2] - 1.0)
    return np.arccos(np.clip(d, -1.0, 1.0))


def _rpy_error(pose_error):
    """|euler('zxy')| per axis (pose_evaluator.py:206-209). Returns [..., 3]."""
    return np.abs(as_euler(pose_error[..., :3, :3], "zxy"))


def _translation_error(pose_error):
    return np.linalg.norm(pose_error[..., :3, 3], axis=-1)


class PoseEvaluator:
    def __init__(self, alignment, length=(100, 200, 300, 400, 500, 600, 700, 800),
                 min_matches=10, max_t_diff=0.05, scale=1.0, offset=0):
        self.lengths = list(length)
        self.num_lengths = len(self.lengths)
        self.min_matches = min_matches
        self.alignment = alignment
        self.max_t_diff = max_t_diff
        self.offset = offset
        self.scale = scale
        self.step_size = 10
        if self.alignment != "6dof" and self.scale != 1.0:
            raise RuntimeError(f"scale = {scale} can only be used with 6dof alignment")
        self.units = {
            "scale": "", "quaternion": "(x, y, z, w)", "translation": "(x, y, z) meters",
            "RTE": "%", "RRE": "deg/100m", "EulerRoll": "deg/100m",
            "EulerPitch": "deg/100m", "EulerYaw": "deg/100m", "ATE": "meters",
            "RRE_m": "deg/m", "RRE_deg": "deg", "ITE": "meters/s", "IRE": "deg/s",
            "instant_roll": "deg/s", "instant_pitch": "deg/s", "instant_yaw": "deg/s",
        }

    # ---------------- loading ----------------

    def load_poses(self, pred_array, gt_array):
        """TUM arrays -> matched pose stacks.  Mirrors pose_evaluator.py:162-184
        including the x,y-only scale quirk."""
        pred_array = np.array(pred_array, dtype=np.float64)
        gt_array = np.asarray(gt_array, dtype=np.float64)
        pred_array[:, 1:3] *= self.scale
        gt_map = {row[0]: row[1:] for row in gt_array}
        pred_map = {row[0]: row[1:] for row in pred_array}
        matches = associate(list(gt_map), list(pred_map), self.max_t_diff, self.offset)
        if len(matches) < self.min_matches:
            print(f"found {len(matches)} matches")
            raise RuntimeError(
                "Couldn't find matching timestamp pairs between groundtruth "
                "and estimated trajectory! Did you choose the correct sequence? "
                "Or try to set a larger t_max_diff."
            )
        gt = np.stack([gt_map[a][:7] for a, b in matches])
        pred = np.stack([pred_map[b][:7] for a, b in matches])
        time_diff = matches[-1][0] - matches[0][0]
        return _tum_rows_to_transforms(pred), _tum_rows_to_transforms(gt), time_diff

    # ---------------- metric pieces (vectorized) ----------------

    def trajectory_distances(self, poses):
        t = poses[:, :3, 3]
        seg = np.linalg.norm(t[1:] - t[:-1], axis=-1)
        return np.concatenate([[0.0], np.cumsum(seg)])

    def calc_sequence_errors(self, poses_gt, poses_result):
        """All (first_frame, length) segment errors at once.  Returns the
        reference's row layout: [first, r/len, t/len, len, speed, roll/len,
        pitch/len, yaw/len] (pose_evaluator.py:253-305)."""
        n = len(poses_gt)
        dist = self.trajectory_distances(poses_gt)
        firsts = np.arange(0, n, self.step_size)
        rows = []
        inv_gt = np.linalg.inv(poses_gt)
        inv_pred = np.linalg.inv(poses_result)
        for length in self.lengths:
            # first i with dist[i] > dist[first] + length
            lasts = np.searchsorted(dist, dist[firsts] + length, side="right")
            ok = lasts < n
            f, l = firsts[ok], lasts[ok]
            if len(f) == 0:
                continue
            delta_gt = inv_gt[f] @ poses_gt[l]
            delta_pred = inv_pred[f] @ poses_result[l]
            err = np.linalg.inv(delta_pred) @ delta_gt
            r_err = _rotation_error(err)
            rpy = _rpy_error(err)
            t_err = _translation_error(err)
            num_frames = (l - f).astype(np.float64) + 1.0
            speed = length / (0.1 * num_frames)
            rows.append(
                np.column_stack([
                    f, r_err / length, t_err / length,
                    np.full(len(f), float(length)), speed,
                    rpy[:, 0] / length, rpy[:, 1] / length, rpy[:, 2] / length,
                ])
            )
        if not rows:
            return np.zeros((0, 8))
        out = np.concatenate(rows)
        # reference iterates first-frames outer, lengths inner; order only
        # matters for file dumps, so normalize to (first, length)
        return out[np.lexsort((out[:, 3], out[:, 0]))]

    def save_sequence_errors(self, err, file_name):
        """Plain-text dump, one row per segment (pose_evaluator.py:307-317)."""
        with open(file_name, "w") as fp:
            for row in np.asarray(err):
                fp.write(" ".join(str(v) for v in row) + "\n")

    def compute_segment_error(self, seq_errs):
        avg = {}
        for length in self.lengths:
            sel = seq_errs[seq_errs[:, 3] == length] if len(seq_errs) else seq_errs
            if len(sel):
                avg[length] = [
                    sel[:, 2].mean(), sel[:, 1].mean(),
                    sel[:, 5].mean(), sel[:, 6].mean(), sel[:, 7].mean(),
                ]
            else:
                avg[length] = []
        return avg

    def compute_overall_err(self, seq_err):
        if len(seq_err) == 0:
            return 0, 0, 0, 0, 0
        return (
            seq_err[:, 2].mean(), seq_err[:, 1].mean(),
            seq_err[:, 5].mean(), seq_err[:, 6].mean(), seq_err[:, 7].mean(),
        )

    def compute_ATE(self, gt, pred):
        err = np.linalg.norm(gt[:, :3, 3] - pred[:, :3, 3], axis=-1)
        return float(np.sqrt(np.mean(err**2)))

    def compute_RPE(self, gt, pred):
        gt_rel = np.linalg.inv(gt[:-1]) @ gt[1:]
        pred_rel = np.linalg.inv(pred[:-1]) @ pred[1:]
        rel_err = np.linalg.inv(gt_rel) @ pred_rel
        return float(_translation_error(rel_err).mean()), float(_rotation_error(rel_err).mean())

    def calculate_instant_error(self, gt, pred):
        gt_rel = np.linalg.inv(gt[:-1]) @ gt[1:]
        pred_rel = np.linalg.inv(pred[:-1]) @ pred[1:]
        rel = np.linalg.inv(gt_rel) @ pred_rel
        rpy = _rpy_error(rel)
        return {
            "ITE": float(np.abs(_translation_error(rel)).mean()),
            "IRE": float(np.abs(_rotation_error(rel)).mean()),
            "instant_roll": float(rpy[:, 0].mean()),
            "instant_pitch": float(rpy[:, 1].mean()),
            "instant_yaw": float(rpy[:, 2].mean()),
        }

    def scale_lse_solver(self, X, Y):
        return float(np.sum(X * Y) / np.sum(X**2))

    def scale_optimization(self, gt, pred):
        scale = self.scale_lse_solver(pred[:, :3, 3], gt[:, :3, 3])
        out = pred.copy()
        out[:, :3, 3] *= scale
        return out

    # ---------------- orchestration ----------------

    def eval(self, gt_array, pred_array):
        result = {}
        pred, gt, time_diff = self.load_poses(pred_array, gt_array)
        frame_rate = float(len(gt)) / time_diff

        # first-frame alignment (pose_evaluator.py:619-624)
        pred = np.linalg.inv(pred[0]) @ pred
        gt = np.linalg.inv(gt[0]) @ gt

        alignment = self.alignment
        if alignment == "scale":
            pred = self.scale_optimization(gt, pred)
        elif alignment in ("scale_7dof", "7dof", "6dof"):
            xyz_pred = pred[:, :3, 3].T
            xyz_gt = gt[:, :3, 3].T
            r, t, scale = umeyama_alignment(xyz_pred, xyz_gt, alignment != "6dof")
            result["scale"] = scale if self.scale == 1.0 else self.scale
            result["quaternion"] = matrix_to_quat(r)
            result["translation"] = t
            align = np.eye(4)
            align[:3, :3] = r
            align[:3, 3] = t
            pred = pred.copy()
            pred[:, :3, 3] *= scale
            if alignment in ("7dof", "6dof"):
                pred = align @ pred

        seq_err = self.calc_sequence_errors(gt, pred)
        avg_segment_errs = self.compute_segment_error(seq_err)
        ave_t, ave_r, ave_roll, ave_pitch, ave_yaw = self.compute_overall_err(seq_err)
        ate = self.compute_ATE(gt, pred)
        rpe_trans, rpe_rot = self.compute_RPE(gt, pred)
        instant = self.calculate_instant_error(gt, pred)

        result["RTE"] = ave_t * 100
        result["RRE"] = ave_r / np.pi * 180 * 100
        result["EulerRoll"] = ave_roll / np.pi * 180 * 100
        result["EulerPitch"] = ave_pitch / np.pi * 180 * 100
        result["EulerYaw"] = ave_yaw / np.pi * 180 * 100
        result["ATE"] = ate
        result["RRE_m"] = rpe_trans
        result["RRE_deg"] = rpe_rot * 180 / np.pi
        result["ITE"] = instant["ITE"] * frame_rate
        result["IRE"] = instant["IRE"] * frame_rate / np.pi * 180
        result["instant_roll"] = instant["instant_roll"] * frame_rate / np.pi * 180
        result["instant_pitch"] = instant["instant_pitch"] * frame_rate / np.pi * 180
        result["instant_yaw"] = instant["instant_yaw"] * frame_rate / np.pi * 180

        self.poses_gt = gt
        self.poses_pred = pred
        self.avg_segment_errs = avg_segment_errs
        return result

    # ---------------- plotting ----------------

    def plot_trajectory(self, plot_mode="xz"):
        xyz = {"x": 0, "y": 1, "z": 2}
        if len(plot_mode) != 2 or any(c not in xyz for c in plot_mode):
            raise KeyError("plot_mode must be one of [xy, yx, xz, zx, yz, zy]")
        a, b = xyz[plot_mode[0]], xyz[plot_mode[1]]
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig = plt.figure()
        ax = plt.gca()
        ax.set_aspect("equal")
        for key, poses in (("Ground Truth", self.poses_gt), ("Ours", self.poses_pred)):
            plt.plot(poses[:, a, 3], poses[:, b, 3], label=key)
        plt.legend(loc="upper right", prop={"size": 20})
        plt.xlabel(f"{plot_mode[0]} (m)", fontsize=20)
        plt.ylabel(f"{plot_mode[1]} (m)", fontsize=20)
        fig.set_size_inches(10, 10)
        return _fig_to_rgb(fig)

    def plot_error(self):
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        images = []
        for idx, (label, unit, conv) in enumerate([
            ("Translation Error", "%", lambda e: e[0] * 100),
            ("Rotation Error", "deg/100m", lambda e: e[1] / np.pi * 180 * 100),
        ]):
            xs, ys = [], []
            for length in self.lengths:
                xs.append(length)
                errs = self.avg_segment_errs[length]
                ys.append(conv(errs) if errs else 0)
            fig = plt.figure()
            plt.plot(xs, ys, "bs-", label=label)
            plt.ylabel(f"{label} ({unit})", fontsize=10)
            plt.xlabel("Path Length (m)", fontsize=10)
            plt.legend(loc="upper right", prop={"size": 10})
            fig.set_size_inches(5, 5)
            images.append(_fig_to_rgb(fig))
            plt.close(fig)
        return tuple(images)


def _fig_to_rgb(fig):
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    data = data.reshape(fig.canvas.get_width_height()[::-1] + (4,))
    return data[..., :3].copy()


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Command line interface for pose evaluation.")
    parser.add_argument("--pred", required=True, help="pred txt path")
    parser.add_argument("--gt", required=True, help="gt txt path")
    parser.add_argument("--alignment", default="7dof",
                        choices=["7dof", "6dof", "scale", "None"], help="alignment methods")
    parser.add_argument("--t_max_diff", default=0.05, type=float,
                        help="maximum diff time in seconds allowed for sync")
    parser.add_argument("--scale", default=1.0, type=float,
                        help="translation scale for 6dof alignment")
    parser.add_argument("--extrinsic", default=None, type=str,
                        help="extrinsic from the pred-sensor to gt-sensor, e.g. "
                             "camera_front2lidar_top; looks for attribute.json in . or ..")
    parser.add_argument("--plot-dir", default=None, type=str,
                        help="directory to write trajectory.png, "
                             "translation_error.png and rotation_error.png "
                             "(the reference evaluator's plot set, "
                             "cama/pose_evaluator.py:349-459)")
    parser.add_argument("--plot-mode", default="xz", type=str,
                        help="trajectory plot axes, two of xyz (default xz)")
    args = parser.parse_args(argv)

    pred_array = np.loadtxt(args.pred)
    gt_array = np.loadtxt(args.gt)
    if args.extrinsic:
        import os

        from cama_tpu_torch.io.clip import ClipReader
        from cama_tpu_torch.se3 import Trajectory

        clip_path = "." if os.path.exists("attribute.json") else "../"
        reader = ClipReader(clip_path)
        # split on the FIRST '2' only: sensor names can contain digits
        # (e.g. camera_front2UB482 -> camera_front, UB482; the reference's
        # full split would truncate the target to 'UB48')
        from_sensor, _, to_sensor = args.extrinsic.partition("2")
        if not to_sensor:
            raise SystemExit(f"--extrinsic must look like from2to, got {args.extrinsic!r}")
        pred2gt = reader.extrinsic(from_sensor, to_sensor)
        if pred2gt is None:
            raise SystemExit(
                f"no extrinsic path from {from_sensor!r} to {to_sensor!r} in "
                f"{clip_path}/attribute.json")
        tr = Trajectory()
        tr.loadarray(pred_array)
        tr.transform(pred2gt)
        pred_array = tr.dumparray()

    pe = PoseEvaluator(alignment=args.alignment, max_t_diff=args.t_max_diff, scale=args.scale)
    result = pe.eval(gt_array, pred_array)
    np.set_printoptions(precision=2)
    for key, value in result.items():
        try:
            print("{}= {:0.2f} {}".format(key.ljust(14), value, pe.units[key]))
        except (TypeError, ValueError):
            print(key.ljust(12), " = ", value, " ", pe.units[key])
    if args.plot_dir:
        import os

        os.makedirs(args.plot_dir, exist_ok=True)
        _write_png(os.path.join(args.plot_dir, "trajectory.png"),
                   pe.plot_trajectory(args.plot_mode))
        te, re_ = pe.plot_error()
        _write_png(os.path.join(args.plot_dir, "translation_error.png"), te)
        _write_png(os.path.join(args.plot_dir, "rotation_error.png"), re_)
        print(f"plots written to {args.plot_dir}")


def _write_png(path, rgb):
    """RGB array -> PNG on disk (cv2 when present, else matplotlib; the RGB
    arrays come from _fig_to_rgb)."""
    try:
        import cv2

        cv2.imwrite(path, rgb[..., ::-1])
    except ImportError:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plt.imsave(path, rgb)


if __name__ == "__main__":
    main()
