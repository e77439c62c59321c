"""cama_tpu_torch.aggregate.site against cama_tpu.aggregate.site on CPU, on
the same fixture clips (two clips over overlapping road, the second in an
SE(2)-misaligned SfM frame) and on seeded point sets: the Sim(3) estimate
within 1e-9; the batched chamfer within 1e-6 relative; the pair loss's
autograd gradient against finite differences in float64, through a tie in
the minimum; the Adam refinement at 1 and 10 steps (deltas within 1e-4,
the first loss within 1e-6 relative) and at 600 steps (the final loss
within 2 %); dedupe keep masks equal; the member reprojection equal to
the per-clip one and to JAX's at the f32 device-lane contract; and the
CLI's `sites:` block."""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from cama_tpu.aggregate import site as jsite
from cama_tpu.io import scene as jscene
from cama_tpu_torch.aggregate import site as tsite
from cama_tpu_torch.io import scene as tscene
from cama_tpu_torch.io.fixture import make_fixture_clip

AGREE_MIN = 0.99999  # per-frame raster agreement, the f32 device-lane contract


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def site_clips(tmp_path_factory):
    """The site clips of tests/test_aggregate.py, with small JPEGs so the
    CLI can write the member videos (the port's fixture writes the JAX
    fixture's bytes: tests/test_torch_aggregate.py)."""
    root = tmp_path_factory.mktemp("tsite") / "converted"
    common = dict(n_frames=14, image_size=(320, 180), flat_height=True)
    a = make_fixture_clip(root, scene_name="scene-a", **common)
    b = make_fixture_clip(root, scene_name="scene-b", traj_t_offset=0.7,
                          t0_ms=1600000100000,
                          world_sim3={"yaw_deg": 8.0, "tx": 15.0, "ty": -7.0},
                          **common)
    return a, b


@pytest.fixture(scope="module")
def scenes(site_clips):
    """{package: [scene per clip]} compiled by each package's own code."""
    return {"t": [tscene.compile_scene(c, sources=("cama",)) for c in site_clips],
            "j": [jscene.compile_scene(c, sources=("cama",)) for c in site_clips]}


def _site(mod, site_clips, scenes, **kw):
    site = mod.Site(name="s", **kw)
    for path, scene in zip(site_clips, scenes):
        site.add_clip(path, scene)
    return site


def _perturb(site):
    """Clip 1's Sim(3) and points moved by a known 1.5 deg, (0.8, -0.5,
    0.1) m (tests/test_aggregate.py)."""
    ang = np.deg2rad(1.5)
    Rp = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    tp = np.array([0.8, -0.5, 0.1])
    path1, scene1, (r1, t1, s1) = site.clips[1]
    site.clips[1] = (path1, scene1, (Rp @ r1, Rp @ t1 + tp, s1))
    site.instances = [
        (c, (p @ Rp.T + tp).astype(np.float32) if ci == 1 else p, ci)
        for c, p, ci in site.instances]
    return site


def _generated_instances(n=120, n_clips=4, seed=42):
    """tests/test_aggregate.py's randomized site: curves around 30 shared
    centres, three classes, 4-400 points each, three noise levels."""
    rng = np.random.default_rng(seed)
    classes = ["lane_marking", "Crosswalk_Line", "stop_line"]
    base = [(rng.uniform(-40, 40, 2), rng.uniform(0.5, 3.0)) for _ in range(30)]
    out = []
    for k in range(n):
        center, radius = base[rng.integers(0, len(base))]
        m = int(rng.integers(4, 400))
        t = np.linspace(0, 1, m)
        pts = np.stack([center[0] + radius * t * 10,
                        center[1] + np.sin(t * 6) * radius, 0.1 * t],
                       axis=1).astype(np.float32)
        pts += rng.normal(0, rng.choice([0.01, 0.2, 1.5]), pts.shape).astype(np.float32)
        out.append((classes[k % 3], pts, k % n_clips))
    return out


def _utm_instances():
    offset = np.array([3.6e5, 4.69e6, 12.0])
    t = np.linspace(0, 1, 120)
    base = np.stack([t * 30, np.sin(t * 5) * 2, 0 * t], 1)
    return [("lane_marking", base + offset, 0),
            ("lane_marking", base + offset + [0.05, 0.0, 0.0], 1),
            ("lane_marking", base + offset + [0.0, 1.2, 0.0], 1)]


def test_sim3_matches_jax(site_clips, scenes):
    for ts, js in zip(scenes["t"], scenes["j"]):
        got = tsite.estimate_sim3_to_world(ts)
        ref = jsite.estimate_sim3_to_world(js)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)
    r, t, s = tsite.estimate_sim3_to_world(scenes["t"][1])
    yaw = np.deg2rad(8.0)
    M = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
    np.testing.assert_allclose(r[:2, :2], M.T, atol=1e-6)
    np.testing.assert_allclose(s, 1.0, atol=1e-6)


def _padded_sets(seed, I=20, S=48):
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=2.0, size=(I, S, 3)).astype(np.float32)
    w = np.zeros((I, S), np.float32)
    for k in range(I):
        n = int(rng.integers(1, S + 1))
        w[k, :n] = 1.0 / n
        pts[k, n:] = 0
    jj, ii = np.nonzero(np.tril(np.ones((I, I), bool), -1))
    return pts, w, ii, jj


def test_chamfer_pairs_matches_jax(monkeypatch):
    """Against JAX's jitted _chamfer_pairs and the NumPy mirror, in one op
    group and in groups of one block (the grouping does not change a
    pair's value)."""
    pts, w, ii, jj = _padded_sets(7)
    ref = np.asarray(jsite._chamfer_pairs(pts, w, ii.astype(np.int32),
                                          jj.astype(np.int32)))
    args = (torch.from_numpy(pts), torch.from_numpy(w), torch.from_numpy(ii),
            torch.from_numpy(jj))
    got = tsite._chamfer_pairs(*args).numpy()
    assert got.dtype == np.float32 and len(got) == len(ii) > tsite.PAIR_BLOCK
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, tsite._chamfer_pairs_host(pts, w, ii, jj),
                               rtol=1e-6)
    monkeypatch.setattr(tsite, "GROUP_BYTES", 1)
    assert tsite._group_pairs(pts.shape[1]) == tsite.PAIR_BLOCK
    np.testing.assert_array_equal(tsite._chamfer_pairs(*args).numpy(), got)


def test_pair_loss_gradcheck_through_a_tie():
    """float64 autograd against central differences.  Instance 0's first
    point sits at the rotation centre, and two points of instance 1 lie
    opposite each other about it: with equal translations the two stay
    equidistant from it under every rotation and scale, a tie in the
    minimum.  The central difference there is the mean of the two
    one-sided slopes, which is what an equal split of the gradient gives."""
    S = 4
    pts = np.zeros((3, S, 3))
    w = np.zeros((3, S))
    pts[0, :2] = [[0.0, 0.0, 0.0], [3.0, 1.0, 0.5]]
    pts[1, :3] = [[1.0, 2.0, 0.5], [-1.0, -2.0, -0.5], [4.0, 0.0, 1.0]]
    pts[2, :4] = [[0.5, 2.5, 0.0], [2.0, -1.0, 0.3], [-3.0, 1.0, 0.2], [1.0, 1.0, 1.0]]
    for k, n in enumerate((2, 3, 4)):
        w[k, :n] = 1.0 / n
    t = torch.from_numpy
    data = {"pts": t(pts), "w": t(w), "ii": t(np.array([0, 0, 1])),
            "jj": t(np.array([1, 2, 2])), "clip": t(np.array([0, 1, 2])),
            "center": t(np.zeros(3))}
    rng = np.random.default_rng(9)
    rot = t(rng.normal(scale=0.1, size=(3, 3))).requires_grad_()
    trans = torch.zeros(3, 3, dtype=torch.float64, requires_grad=True)
    log_s = t(rng.normal(scale=0.05, size=3)).requires_grad_()

    def loss(rot, trans, log_s):
        return tsite.pair_loss({"rot": rot, "t": trans, "log_s": log_s}, data)

    # the tie is real: instance 0's first point is equidistant from the two
    with torch.no_grad():
        R = tsite._rotvec_to_matrix(rot)[1]
        b = torch.exp(log_s[1]) * (t(pts[1, :2]) @ R.T)
        assert torch.equal((b[0] ** 2).sum(), (b[1] ** 2).sum())
    assert torch.autograd.gradcheck(loss, (rot, trans, log_s), eps=1e-6,
                                    atol=1e-6, rtol=1e-4)


@pytest.fixture(scope="module")
def refine_inputs():
    """_candidate_pairs of the 120-instance site at tol 2.0: float32
    points and weights, cross-clip same-class pairs over 4 clips."""
    pts, w, ii, jj, clip, _ = jsite._candidate_pairs(_generated_instances(), 128, 2.0)
    assert len(ii) > jsite.PAIR_BLOCK  # two blocks, the second padded
    return pts, w, ii, jj, clip


@pytest.mark.parametrize("iters", [1, 10])
def test_optimize_pair_deltas_matches_jax(refine_inputs, iters):
    """At 1 step Adam moves each free parameter by ~lr * sign(gradient), so
    the deltas agree only if every gradient's sign does.  The step is small
    enough that it lowers the loss (a larger one is declined by both)."""
    pts, w, ii, jj, clip = refine_inputs
    n = len(ii)
    pad = (-n) % jsite.PAIR_BLOCK
    lr = 1e-3
    ref = jsite._optimize_pair_deltas(
        pts, w, np.pad(ii, (0, pad)), np.pad(jj, (0, pad)),
        np.pad(np.ones(n, np.float32), (0, pad)), clip, 4, n, iters, lr)
    got = tsite._optimize_pair_deltas(pts, w, ii, jj, clip, 4, iters, lr,
                                      device="cpu")
    assert ref[0] is not None and got[0] is not None
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        assert not g[0].any()  # clip 0 anchored
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5)
    if iters == 1:
        assert np.abs(got[0][1][1:]).min() > 0.9 * lr


def test_refine_alignment_recovers_perturbation_like_jax(site_clips, scenes):
    tref = _perturb(_site(tsite, site_clips, scenes["t"], device="cpu"))
    jref = _perturb(_site(jsite, site_clips, scenes["j"]))
    t_before, t_after = tref.refine_alignment(iters=600, lr=2e-2, tol=4.0)
    j_before, j_after = jref.refine_alignment(iters=600, lr=2e-2, tol=4.0,
                                              backend="device")
    np.testing.assert_allclose(t_before, j_before, rtol=1e-6)
    assert t_before > 2.0
    assert t_after < 0.45 * t_before and j_after < 0.45 * j_before
    assert abs(t_after - j_after) <= 0.02 * j_after, (t_after, j_after)
    # the folded Sim(3)s are consistent with the refined instance points
    for cls_name, pts, ci in tref.instances[:3]:
        _, _, (r, t, s) = tref.clips[ci]
        local = ((np.asarray(pts, np.float64) - t) @ np.asarray(r)) / s
        np.testing.assert_allclose(tsite.apply_sim3_points(local, r, t, s),
                                   pts, atol=1e-3)
    assert tref.dedupe(tol=0.5) > 0


def _kept(site):
    return [(c, ci, len(p)) for c, p, ci in site.instances]


@pytest.mark.parametrize("case", ["site_clips", "generated", "utm"])
def test_dedupe_matches_jax(case, site_clips, scenes):
    if case == "site_clips":
        tref = _site(tsite, site_clips, scenes["t"], device="cpu")
        jref = _site(jsite, site_clips, scenes["j"])
    else:
        inst = _generated_instances() if case == "generated" else _utm_instances()
        tref, jref = tsite.Site(name="g", device="cpu"), jsite.Site(name="g")
        tref.instances, jref.instances = list(inst), list(inst)
    removed = tref.dedupe(tol=0.5)
    assert removed == jref.dedupe(tol=0.5) > 0
    assert _kept(tref) == _kept(jref)
    for (_, a, _), (_, b, _) in zip(tref.instances, jref.instances):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    if case == "site_clips":  # both clips label the same 8 polylines
        assert [ci for _, ci, _ in _kept(tref)] == [0] * 8


def test_member_overlay_rasters(site_clips, scenes):
    """The merged map through MultiScenePipeline equals each member's own
    pipeline on the injected 'site' source, and the JAX package's at the
    f32 device-lane contract."""
    tref = _site(tsite, site_clips, scenes["t"], device="cpu")
    tref.dedupe()
    got = {(ci, idx): r for ci, idx, r in tref.member_overlay_rasters(chunk=4)}
    assert {ci for ci, _ in got} == {0, 1}
    for ci in range(2):
        solo = dict(tref.pipeline_for_clip(ci, chunk=4).iter_overlay_rasters("site"))
        assert {i for c, i in got if c == ci} == set(solo)
        for idx, r in solo.items():
            np.testing.assert_array_equal(got[(ci, idx)], r)
    jref = _site(jsite, site_clips, scenes["j"])
    jref.dedupe()
    ref = {(ci, idx): r for ci, idx, r in jref.member_overlay_rasters(chunk=4)}
    assert ref.keys() == got.keys()
    for key, r in ref.items():
        agree = (got[key] == r).mean()
        assert agree >= AGREE_MIN, (key, agree)


def test_run_sites_string_and_duplicate_names(tmp_path):
    """A plain-string site entry means one scene (not its characters), and
    duplicate site names fail that site instead of overwriting outputs."""
    from cama_tpu_torch.cli import _run_sites

    cfgs = {"sites": ["scene-x", {"name": "s", "scenes": ["a"]},
                      {"name": "s", "scenes": ["b"]}]}
    failures = _run_sites(cfgs, [], str(tmp_path), str(tmp_path), "cpu")
    assert len(failures) == 3
    assert "scene-x" in failures[0][1] and "'s'" not in failures[0][1]
    assert "duplicate site name" in failures[2][1]


def test_cli_sites_block(site_clips, tmp_path, capsys):
    """`python -m cama_tpu_torch.cli --config cfg.yaml --device cpu` with a
    `sites:` block: exit 0, the site's labels and one video per member;
    the merged map is the JAX package's (the site the JAX CLI builds: the
    same clips, refined), element for element within 1e-3 m."""
    from cama_tpu_torch.cli import main

    conv = os.path.dirname(site_clips[0])
    names = [os.path.basename(c) for c in site_clips]
    cfg = {"converted_dataroot": conv, "scene_names": names,
           "output_video_dir": str(tmp_path / "videos"),
           "sites": [{"name": "overlap", "scenes": names, "refine": True}]}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[overlap] aggregating 2 scenes on cpu (+refine)" in out
    videos = sorted(os.listdir(tmp_path / "videos"))
    assert videos == sorted(["overlap_labels.json", "overlap_scene-a_site.mp4",
                             "overlap_scene-b_site.mp4"]
                            + [f"{n}_{s}.mp4" for n in names
                               for s in ("cama", "nuScenes")])
    for v in videos:
        assert (tmp_path / "videos" / v).stat().st_size > 0, v
    with open(tmp_path / "videos" / "overlap_labels.json") as f:
        got = json.load(f)
    ref = jsite.Site.from_clips(list(site_clips), refine=True,
                                configs={"raster_kernel": "auto"})
    assert [r["attrs"]["type"] for r in got] == [c for c, _, _ in ref.instances]
    for rec, (_, pts, _) in zip(got, ref.instances):
        np.testing.assert_allclose(np.asarray(rec["data"]), pts[:, :2],
                                   rtol=0, atol=1e-3)
