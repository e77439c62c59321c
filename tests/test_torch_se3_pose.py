"""cama_tpu_torch.se3 (core, codec, trajectory), the clip reader's pose
streams and cama_tpu_torch.eval.pose_metrics against their JAX-package
originals on identical float64 arrays made from a seed with NumPy: exact
where the original runs NumPy, within 1e-12 relative where the port's
torch prefix product stands in for JAX's associative scan.  The pose
evaluator is also held to tests/golden/pose_eval.npz and
pose_transformer.npz as tests/test_golden.py holds the JAX package.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cama_tpu.eval import pose_metrics as jpm
from cama_tpu.io import clip as jclip
from cama_tpu.io import fixture as jfixture
from cama_tpu.se3 import codec as jcodec
from cama_tpu.se3 import core as jcore
from cama_tpu.se3 import trajectory as jtraj
from cama_tpu_torch import se3 as tse3
from cama_tpu_torch.eval import pose_metrics as tpm
from cama_tpu_torch.io import clip as tclip

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ALIGNMENTS = ["None", "scale", "scale_7dof", "7dof", "6dof"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rigid(rng, n, scale=50.0):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = jcore.quat_to_matrix(rng.normal(size=(n, 4)))
    T[:, :3, 3] = rng.normal(scale=scale, size=(n, 3))
    return T


def _gimbal_matrices():
    """Rotations at both poles of every Tait-Bryan and proper sequence."""
    out = []
    for seq in ("xyz", "zxy", "xzx", "zyz"):
        for beta in (np.pi / 2, -np.pi / 2, 0.0, np.pi):
            q = jcore.from_euler(seq, np.array([0.3, beta, -0.4]))
            out.append(jcore.quat_to_matrix(q))
    return np.stack(out)


@pytest.mark.parametrize("seq", ["xyz", "ZXY", "zxy", "XYZ", "zyz", "XZX"])
@pytest.mark.parametrize("degrees", [False, True])
def test_euler_bit_identical(seq, degrees):
    rng = np.random.default_rng(1)
    angles = rng.uniform(-3.0, 3.0, size=(32, 3)) * (57.3 if degrees else 1.0)
    np.testing.assert_array_equal(tse3.from_euler(seq, angles, degrees),
                                  jcore.from_euler(seq, angles, degrees))
    np.testing.assert_array_equal(tse3.from_euler(seq, angles[0], degrees),
                                  jcore.from_euler(seq, angles[0], degrees))
    m = np.concatenate([_rigid(rng, 32)[:, :3, :3], _gimbal_matrices()])
    np.testing.assert_array_equal(tse3.as_euler(m, seq, degrees),
                                  jcore.as_euler(m, seq, degrees))


def test_rel_abs_chain():
    """NumPy: the host loop, bit for bit.  A torch tensor: the prefix
    product against JAX's associative scan in float64, within 1e-12."""
    rng = np.random.default_rng(2)
    rel = _rigid(rng, 37, scale=2.0)
    np.testing.assert_array_equal(tse3.rel_to_abs(rel), jcore.rel_to_abs(rel))
    np.testing.assert_array_equal(tse3.abs_to_rel(rel), jcore.abs_to_rel(rel))
    with jax.enable_x64(True):
        ref = np.asarray(jcore.rel_to_abs(jnp.asarray(rel)))
    assert ref.dtype == np.float64
    got = tse3.rel_to_abs(torch.from_numpy(rel))
    assert got.dtype == torch.float64 and got.shape == (38, 4, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), tse3.rel_to_abs(rel),
                               rtol=1e-12, atol=1e-12)


def test_codecs_bit_identical(tmp_path):
    rng = np.random.default_rng(3)
    T = _rigid(rng, 20)
    ts = 1.6e9 + np.arange(20) * 0.1
    np.testing.assert_array_equal(tse3.transforms_to_tum(T, ts),
                                  jcodec.transforms_to_tum(T, ts))
    kitti = T[:, :3, :4].reshape(-1, 12)
    asl = np.concatenate([ts[:, None] * 1e9, T[:, :3, 3],
                          rng.normal(size=(20, 4)), rng.normal(size=(20, 9))], 1)
    tum = jcodec.transforms_to_tum(T, ts)
    for style, rows in (("tum", tum), ("kitti", kitti), ("asl", asl)):
        path = tmp_path / f"{style}.txt"
        np.savetxt(path, rows)
        a, b = tse3.load_trajectory_txt(path, style), jcodec.load_trajectory_txt(path, style)
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None)
        if a[1] is not None:
            np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(NotImplementedError):
        tse3.load_trajectory_txt(tmp_path / "tum.txt", "euroc")


@pytest.mark.parametrize("interpolate", [True, False])
def test_seek_by_timestamps_bit_identical(interpolate):
    rng = np.random.default_rng(4)
    ts = np.cumsum(rng.uniform(0.05, 0.4, size=30)) + 1.6e9
    q = np.concatenate([rng.uniform(ts[0] - 1, ts[-1] + 1, 40), ts[::5]])
    T = _rigid(rng, 30)
    a = tse3.seek_by_timestamps(ts, T, q, 0.3, interpolate)
    b = jtraj.seek_by_timestamps(ts, T, q, 0.3, interpolate)
    assert a[1].any() and not a[1].all()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _drive(tr, rows, E, rng):
    """Every method of the full Trajectory on one instance; returns what
    each gives."""
    out = []
    tr.loadarray(rows)
    for absolute in (True, False):
        out += [tr.as_transform(absolute), tr.as_euler(absolute),
                tr.as_axis_angle(absolute), tr.as_translations(absolute)]
    out += [tr.as_quaternions(), tr.as_trans_quat(), tr.get_timestamps(),
            tr.dumparray()]
    tr.transform(E)
    out.append(tr.as_transform())
    tr.left_rotate(E)
    tr.right_rotate(E)
    out += [tr.as_transform(), tr.as_transform(False)]
    tr.normalize2origin()
    out.append(tr.as_transform())
    tr.normalize2center()
    out.append(tr.as_transform())
    out.append(tr.seek_by_timestamp(rows[3, 0] + 0.01, 0.5, interpolate=True))
    out += list(tr.seek_many(rows[:, 0] + 0.03, 0.5))
    with pytest.raises(RuntimeError):
        tr.seek_by_timestamp(rows[-1, 0] + 10.0, 0.5)
    tr.load_timestamp(rows[::-1, 0])
    tr.sort_by_timestamps()
    out += [tr.timestamps, tr.as_transform()]
    # relative pieces: rotations (quaternions, Euler, axis-angle) and
    # translations, composed and inverted as the reference does
    n = 6
    for loader in ("quat", "euler", "axis"):
        tr.reset()
        if loader == "quat":
            tr.from_relative_quaternion(rng.normal(size=(n, 4)))
        elif loader == "euler":
            tr.from_relative_eulers(rng.uniform(-1, 1, size=(n, 3)))
        else:
            tr.from_axis_angle(rng.normal(size=(n, 3)), absolute=False)
        tr.from_translation(rng.normal(size=(n, 3)), absolute=False)
        out += [tr.as_transform(False), tr.as_transform(True)]
    tr.reset()
    tr.from_axis_angle(rng.normal(size=(n, 3)), absolute=True)
    tr.from_translation(rng.normal(size=(n, 3)), absolute=True)
    out.append(tr.as_transform())
    tr.from_relative_transform(_rigid(rng, n))
    out.append(tr.as_transform())
    tr.from_absolute_transform(_rigid(rng, n))
    out.append(tr.as_transform(False))
    for style, arr in (("kitti", _rigid(rng, n)[:, :3, :4].reshape(-1, 12)),):
        tr.loadarray(arr, style=style)
        out.append(tr.as_transform(False))
    return out


def test_trajectory_every_method_bit_identical():
    rng = np.random.default_rng(5)
    rows = jcodec.transforms_to_tum(_rigid(rng, 12, scale=5.0),
                                    1.6e9 + np.arange(12) * 0.1)
    E = _rigid(rng, 1)[0]
    for euler_order, degree in (("ZXY", False), ("xyz", True)):
        got = _drive(tse3.Trajectory(euler_order, degree), rows.copy(), E,
                     np.random.default_rng(6))
        ref = _drive(jtraj.Trajectory(euler_order, degree), rows.copy(), E,
                     np.random.default_rng(6))
        assert len(got) == len(ref)
        for k, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(a, b, err_msg=f"entry {k}")


def test_trajectory_golden():
    """tests/test_golden.py's pose_transformer checks on the port."""
    z = np.load(os.path.join(GOLDEN, "pose_transformer.npz"), allow_pickle=True)
    tum = z["tum"]
    tr = tse3.Trajectory()
    tr.loadarray(tum.copy())
    np.testing.assert_allclose(tr.as_transform(True), z["abs"], atol=1e-12)
    np.testing.assert_allclose(tr.as_transform(False), z["rel"], atol=1e-12)
    tr.normalize2center()
    np.testing.assert_allclose(tr.as_transform(True), z["normalized_center"], atol=1e-9)
    tr = tse3.Trajectory()
    tr.loadarray(tum.copy())
    tr.transform(z["extrinsic"])
    np.testing.assert_allclose(tr.as_transform(True), z["conjugated"], atol=1e-9)
    tr = tse3.Trajectory()
    tr.loadarray(tum.copy())
    out, valid = tr.seek_many(z["seek_queries"], 0.5, interpolate=True)
    np.testing.assert_array_equal(valid, z["seek_valid"])
    np.testing.assert_allclose(out[valid], z["seek_results"][z["seek_valid"]], atol=1e-9)


@pytest.fixture(scope="module")
def aux_clip(tmp_path_factory):
    return jfixture.make_fixture_clip(
        tmp_path_factory.mktemp("aux"), n_frames=4, with_images=False,
        with_aux_sensors=True)


def test_clip_reader_streams_match(aux_clip):
    a, b = tclip.ClipReader(aux_clip), jclip.ClipReader(aux_clip)
    np.testing.assert_array_equal(a.gnss_tum(), b.gnss_tum())
    for sync in (False, True):
        np.testing.assert_array_equal(a.wheel_tum(sync), b.wheel_tum(sync))
    assert list(a.iter_imu()) == list(b.iter_imu())
    assert a.all_sensors() == b.all_sensors()
    with pytest.warns(UserWarning):
        Ka, da = a.intrinsic("camera_front")
    with pytest.warns(UserWarning):
        Kb, db = b.intrinsic("camera_front")
    np.testing.assert_array_equal(Ka, Kb)
    np.testing.assert_array_equal(da, db)
    for (ta, pa), (tb, pb) in zip(a.iter_lidar(end_idx=3), b.iter_lidar(end_idx=3)):
        assert ta == tb
        np.testing.assert_array_equal(pa, pb)


@pytest.fixture(scope="module")
def pose_golden():
    return np.load(os.path.join(GOLDEN, "pose_eval.npz"), allow_pickle=True)


@pytest.mark.parametrize("alignment", ALIGNMENTS)
def test_pose_evaluator_matches_jax_and_golden(pose_golden, alignment):
    gt, pred = pose_golden["gt"], pose_golden["pred"]
    got = tpm.PoseEvaluator(alignment=alignment).eval(gt.copy(), pred.copy())
    ref = jpm.PoseEvaluator(alignment=alignment).eval(gt.copy(), pred.copy())
    assert got.keys() == ref.keys()
    for key, val in got.items():
        np.testing.assert_array_equal(val, ref[key], err_msg=key)
        gkey = f"{alignment}__{key}"
        if gkey not in pose_golden.files:
            continue
        if key == "quaternion":
            assert abs(np.dot(np.asarray(val), pose_golden[gkey])) > 1 - 1e-9
        else:
            np.testing.assert_allclose(val, pose_golden[gkey], rtol=1e-7,
                                       atol=1e-9, err_msg=gkey)


def test_pose_eval_pieces_and_plots(pose_golden):
    gt, pred = pose_golden["gt"], pose_golden["pred"]
    a = tpm.associate(gt[:, 0], pred[:, 0] + 0.01, 0.05, offset=-0.01)
    assert a == jpm.associate(gt[:, 0], pred[:, 0] + 0.01, 0.05, offset=-0.01)
    x = np.random.default_rng(8).normal(size=(3, 40))
    y = 1.3 * (jcore.quat_to_matrix(np.array([0.1, 0.2, 0.3, 0.9])) @ x) + 2.0
    for with_scale in (False, True):
        for u, v in zip(tpm.umeyama_alignment(x, y, with_scale),
                        jpm.umeyama_alignment(x, y, with_scale)):
            np.testing.assert_array_equal(u, v)
    te = tpm.PoseEvaluator(alignment="7dof")
    je = jpm.PoseEvaluator(alignment="7dof")
    te.eval(gt.copy(), pred.copy())
    je.eval(gt.copy(), pred.copy())
    np.testing.assert_array_equal(te.plot_trajectory("xy"), je.plot_trajectory("xy"))
    for u, v in zip(te.plot_error(), je.plot_error()):
        np.testing.assert_array_equal(u, v)
    with pytest.raises(RuntimeError):
        tpm.PoseEvaluator(alignment="7dof", scale=2.0)


def test_pose_eval_main_extrinsic_and_plots(pose_golden, aux_clip, tmp_path,
                                            monkeypatch, capsys):
    """The script with --extrinsic (read from the clip's attribute.json in
    the working directory) and --plot-dir prints the same report as the
    JAX package's and writes the three plots."""
    gt, pred = pose_golden["gt"], pose_golden["pred"]
    np.savetxt(tmp_path / "gt.txt", gt)
    np.savetxt(tmp_path / "pred.txt", pred)
    monkeypatch.chdir(aux_clip)
    args = ["--pred", str(tmp_path / "pred.txt"), "--gt", str(tmp_path / "gt.txt"),
            "--extrinsic", "camera_front2chassis", "--alignment", "6dof"]
    tpm.main(args + ["--plot-dir", str(tmp_path / "plots")])
    got = capsys.readouterr().out
    jpm.main(args)
    ref = capsys.readouterr().out
    assert got.splitlines()[:-1] == ref.splitlines()
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "rotation_error.png", "trajectory.png", "translation_error.png"]
