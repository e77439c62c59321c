"""The port's CAMAv2 site path, `main.py --config` with a `sites:` block on
the CPU, against the benchmark's float64 plain reference
(camabench/reference/site.py), on the benchmark's site fixture cut to 4
member clips of 2 rows, 40 m windows and 4 frames: the Sim(3)s before the
refinement, the refinement's first loss, the kept instances, the merged
map within site_map_gap's limit and its refinement objective within
site_loss_gap's, the world frame within site_frame_gap's and the
refinement's step and pair counts and first objective within
site_refine_gap's, every member's and site
frame within overlay_mismatch's limit of the reference (the site frames
painted from the program's own merged map and Sim(3)s); the controls over
their limits; planted faults turning the check false (the refinement's
deltas dropped; its steps cut to 300 of 600; the whole site moved by a
wrong pivot; member 0 not held; one member's inverse Sim(3) skipped in its
site video); the site's phases and counters, seen by the benchmark's taps;
and the configuration's refinement and dedupe parameters equal to what the
program runs."""
import inspect
import json
import os

import numpy as np
import pytest
import torch

from camabench import check
from camabench.spec import Spec
from camabench.taps import Taps

SEED = 2500123456789


def tiny_site_config():
    """The camav2_site configuration cut to a CPU test's size."""
    with open(os.path.join(Spec().root, "camabench", "configs", "camav2_site.json")) as f:
        cfg = json.load(f)
    cfg["frames_per_scene"] = 4
    cfg["speed_m_s"] = 3.0  # a 0.25 s track stays well conditioned
    cfg["site"].update(clips=4, rows=2, window_m=40.0, overlap=4)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the cores: one intra-op torch thread each
    (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Run:
    """A SiteLoop over the tiny site with the benchmark's taps installed and
    the program's Site recorded: the Sim(3)s before refinement, the
    refinement's losses and the prefilter's pair counts per call."""

    def __init__(self, root):
        import cama_tpu_torch.aggregate.site as site_mod

        spec = Spec()
        self.spec, self.cfg = spec, tiny_site_config()
        traffic = dict(spec.traffic("site_videos"), sample_frames=200, warm_passes=0)
        self.taps = Taps(False)
        self.taps.install()
        self.rec = rec = {"initial": [], "losses": [], "refine_pairs": [], "dedupe_pairs": []}
        base = site_mod.Site

        class Recorder(base):
            def add_clip(self, clip_path, scene):
                super().add_clip(clip_path, scene)
                rec["initial"].append(self.clips[-1][2])

            def refine_alignment(self, iters=600, lr=2e-2, tol=2.0, subsample=128, **kw):
                rec["refine_pairs"].append(len(site_mod._candidate_pairs(
                    self.instances, subsample, tol)[2]))
                out = super().refine_alignment(iters=iters, lr=lr, tol=tol,
                                               subsample=subsample, **kw)
                rec["losses"].append(out)
                return out

            def dedupe(self, tol=0.5, subsample=256):
                rec["dedupe_pairs"].append(len(site_mod._candidate_pairs(
                    self.instances, subsample, tol)[2]))
                return super().dedupe(tol=tol, subsample=subsample)

        self.site_mod, self.base = site_mod, base
        site_mod.Site = Recorder
        kind = spec.entry("sites")
        self.loop = kind.LOOP("site_video", self.cfg, traffic, SEED, "cpu",
                              str(root / "cache"), str(root / "work"), self.taps)
        os.makedirs(root / "work")
        try:
            self.loop.setup()
        except BaseException:
            self.close()
            raise
        self.taps.start_window()
        self.sound = self.loop.run_pass()
        self.draw = self.loop.window_draws[-1]
        self.timers = list(self.taps.timers)
        self.members = self.loop.reference_members(self.draw)
        self.ref = self.loop.reference_site(self.members)

    def gap(self, draw):
        """site_map_gap of the site the program returned as pass `draw`."""
        rec = self.loop.sites[draw]
        return self.loop.map_gap(rec["instances"], rec["sim3"], self.members)

    def loss_gap(self, draw):
        """site_loss_gap of the site the program returned as pass `draw`."""
        return self.loop.loss_gap(self.loop.sites[draw]["sim3"], self.members, self.ref)

    def frame_gap(self, draw):
        """site_frame_gap of the site the program returned as pass `draw`."""
        rec = self.loop.sites[draw]
        return self.loop.frame_gap(rec["initial"], rec["sim3"][0], self.members, self.ref)

    def refine_gap(self, draw):
        """site_refine_gap of the site the program returned as pass `draw`."""
        rec = self.loop.sites[draw]
        return self.loop.refine_gap(rec["losses"], rec["steps"], rec["pairs"], self.ref)

    def numbers(self, draw):
        """The site's four compared numbers of pass `draw`."""
        return {"site_frame_gap": self.frame_gap(draw), "site_refine_gap": self.refine_gap(draw),
                "site_map_gap": self.gap(draw), "site_loss_gap": self.loss_gap(draw)}

    def site(self, refine=True, draw=None):
        """The program's Site over the member clips as they are on disk (the
        sound pass's labels), as `_run_sites` builds it, recorded as pass
        `draw` (the sound pass's by default)."""
        self.loop._draw = self.draw if draw is None else draw
        configs = dict(self.loop.cama_configs, raster_kernel="auto")
        return self.site_mod.Site.from_clips(self.loop.clip_paths, configs=configs,
                                             refine=refine, device="cpu")

    def close(self):
        self.loop.release()
        self.site_mod.Site = self.base
        self.taps.uninstall()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    r = Run(tmp_path_factory.mktemp("site_ref"))
    yield r
    r.close()


def _limit(name):
    return Spec().limit(name)["limit"]


def test_sim3_before_refinement(run):
    assert len(run.rec["initial"]) == len(run.ref["sim3_initial"]) == 4
    for (R, t, s), (R2, t2, s2) in zip(run.rec["initial"], run.ref["sim3_initial"]):
        assert np.abs(np.asarray(R) - R2).max() <= 1e-9
        assert abs(s - s2) <= 1e-9
        assert np.abs(np.asarray(t) - t2).max() <= 1e-9 * np.abs(t2).max()
    assert run.loop.sites[run.draw]["initial"] == run.rec["initial"]
    assert run.frame_gap(run.draw) <= _limit("site_frame_gap")


def test_refinement_path(run):
    """The program's refinement ran the configured 600 steps over the
    reference's pairs, from an objective within site_refine_gap's limit of
    the float64 one."""
    rec = run.loop.sites[run.draw]
    assert rec["steps"] == len(rec["losses"]) == len(run.ref["losses"]) == 600
    assert rec["pairs"] == run.ref["refine_pairs"] > 0
    assert run.refine_gap(run.draw) <= _limit("site_refine_gap")


def test_first_loss(run):
    (before, after), = run.rec["losses"]
    assert abs(before - run.ref["loss_first"]) <= 1e-5 * run.ref["loss_first"]
    assert after < before and run.ref["loss_final"] < run.ref["loss_first"]


def test_kept_sets_and_map_gap(run):
    """The program keeps what the reference's dedupe keeps of the program's
    refined map (here also what it keeps of its own), its map lies within
    site_map_gap's limit of the reference's through the program's Sim(3)s,
    and those Sim(3)s reach the float64 refinement's objective within
    site_loss_gap's limit."""
    kept = [(c, len(p), m) for c, p, m in run.loop.sites[run.draw]["instances"]]
    assert kept == [(c, len(p), m) for c, p, m in run.ref["instances"]]
    assert 0 < run.ref["removed"] and len(kept) < len(run.ref["refined"])
    assert run.gap(run.draw) <= _limit("site_map_gap")
    assert run.loss_gap(run.draw) <= _limit("site_loss_gap")


def test_frames_match_the_reference(run):
    """Every frame of the pass, the 4 members' own and their site frames,
    within overlay_mismatch's limit; the site frames against the reference
    projection of the program's merged map through its Sim(3)s."""
    samples = run.taps.samples()
    assert {path for (path, _, _), _ in samples} == set(run.loop.sinks)  # one a sink
    assert {src for _, src, _ in run.loop.sinks.values()} == {"cama", "site"}
    assert run.sound == 4 * 2 * 3
    assert run.taps.frames_gap() == 0
    assert run.loop._sample_mismatch() <= _limit("overlay_mismatch")


def test_control_exceeds_the_limit(run):
    ctl = run.loop.reference_site(run.members, torch.bfloat16)
    assert run.loop.map_gap(ctl["instances"], ctl["sim3"], run.members) > _limit("site_map_gap")
    assert run.loop.refine_gap(ctl["losses"], len(ctl["losses"]), ctl["refine_pairs"],
                               run.ref) > _limit("site_refine_gap")
    umeyama32 = [m.sim3_to_world(np.float32) for m in run.members]
    assert run.loop.frame_gap(umeyama32, umeyama32[0], run.members,
                              run.ref) > _limit("site_frame_gap")
    loss = run.loop.loss_gap(ctl["sim3"], run.members, run.ref)
    print(f"bfloat16 control: site_loss_gap {loss!r}, limit {_limit('site_loss_gap')}")


def test_fault_refinement_dropped(run, monkeypatch):
    """The refinement's deltas never applied: the merged map keeps the
    misregistration, and the check fails."""
    monkeypatch.setattr(run.base, "_apply_refine_deltas",
                        lambda self, deltas, before, after, *a: (before, after))
    run.site()
    numbers = {"site_map_gap": run.gap(run.draw), "site_loss_gap": run.loss_gap(run.draw)}
    assert numbers["site_loss_gap"] > _limit("site_loss_gap")
    ok, _ = check.judge(numbers, Spec())
    assert not ok


@pytest.mark.parametrize("fault", ["site_shifted", "member0_free"])
def test_fault_site_frame_moved(run, monkeypatch, fault):
    """Every refined Sim(3) and instance moved by one 1 m shift (the whole
    site moves), or member 0 free to move in the refinement: the members
    agree with each other as before, the world frame they share does not.
    The refinement runs 30 steps to keep the test short; only
    site_frame_gap is read."""
    real, refine = run.base._apply_refine_deltas, run.base.refine_alignment

    def faulty(self, deltas, before, after, center_np, world_center, n_clips):
        if fault == "site_shifted":
            out = real(self, deltas, before, after, center_np, world_center, n_clips)
            shift = np.array([1.0, 0.0, 0.0])
            self.clips = [(p, sc, (R, t + shift, sv)) for p, sc, (R, t, sv) in self.clips]
            self.instances = [(c, q + shift, m) for c, q, m in self.instances]
            return out
        rot, tns, lgs = deltas
        rot, tns = rot.copy(), tns.copy()
        rot[0], tns[0] = 0.5 * rot[1], 0.5 * tns[1]
        return real(self, (rot, tns, lgs), before, after, center_np, world_center, n_clips)

    monkeypatch.setattr(run.base, "_apply_refine_deltas", faulty)
    monkeypatch.setattr(run.base, "refine_alignment",
                        lambda self, iters=600, **kw: refine(self, iters=30, **kw))
    run.site()
    numbers = {"site_frame_gap": run.frame_gap(run.draw)}
    assert numbers["site_frame_gap"] > _limit("site_frame_gap")
    ok, _ = check.judge(numbers, Spec())
    assert not ok


def test_fault_member_inverse_skipped(run, monkeypatch):
    """Member 1's site video painted from the merged map in the world frame
    (its inverse Sim(3) skipped): its site frames leave the reference."""
    real = run.base.pipeline_for_clip

    def skipped(self, clip_index, chunk=8):
        if clip_index != 1:
            return real(self, clip_index, chunk)
        path, scene, sim3 = self.clips[1]
        self.clips[1] = (path, scene, (np.eye(3), np.zeros(3), 1.0))
        try:
            return real(self, clip_index, chunk)
        finally:
            self.clips[1] = (path, scene, sim3)

    monkeypatch.setattr(run.base, "pipeline_for_clip", skipped)
    site = run.site(refine=False, draw=run.taps.begin_pass())
    list(site.member_overlay_videos(run.loop.videos, prefix=run.loop.site_name))
    run.taps.end_pass()
    numbers = {"overlay_mismatch": run.loop._sample_mismatch()}
    ok, _ = check.judge(numbers, Spec())
    assert not ok


def test_refinement_stopped_at_300_steps(run, monkeypatch):
    """A refinement cut to 300 of its 600 steps: its map through its own
    Sim(3)s is as exact, and the objective it reaches is no worse than
    the 600-step reference's (the objective stops improving long before),
    so only its step count tells it apart, and the check fails on that."""
    real = run.base.refine_alignment
    monkeypatch.setattr(run.base, "refine_alignment",
                        lambda self, iters=600, **kw: real(self, iters=300, **kw))
    run.site()
    numbers = run.numbers(run.draw)
    print(f"after 300 of 600 steps: {numbers}")
    assert np.isfinite(numbers["site_map_gap"])
    assert numbers["site_loss_gap"] <= _limit("site_loss_gap")
    assert numbers["site_refine_gap"] == float("inf")
    ok, _ = check.judge(numbers, Spec())
    assert not ok


def test_phases_and_counters_seen_by_the_taps(run):
    """Site.timers, made through profiling.PhaseTimers, is the taps' timer:
    its phases are timed, and its pair counters equal the prefilter's
    lengths."""
    site_timers = [t for t in run.timers if "site_refine" in t.total]
    assert len(site_timers) == 1
    t = site_timers[0]
    assert {"site_align", "site_refine", "site_dedupe"} <= set(t.total)
    assert t.count["site_align"] == 4 and t.count["site_refine"] == 1
    assert t.count["site_refine_pairs"] == run.rec["refine_pairs"][0] > 0
    assert t.count["site_dedupe_pairs"] == run.rec["dedupe_pairs"][0] > 0
    assert t.count["site_refine_steps"] == 600
    assert t.count["site_instances"] == len(run.ref["refined"])
    assert t.count["site_removed"] == run.ref["removed"]


def test_config_matches_what_the_program_runs(run):
    """camav2_site's refinement and dedupe parameters, which the reference
    and the yardstick read, are the defaults `_run_sites` runs the port's
    Site with."""
    Site, site = run.base, tiny_site_config()["site"]

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    refine = defaults(Site.refine_alignment)
    assert {"iters": refine["iters"], "lr": refine["lr"], "tol_m": refine["tol"],
            "subsample": refine["subsample"]} == site["refine"]
    assert {"tol_m": defaults(Site.from_clips)["dedupe_tol"],
            "subsample": defaults(Site.dedupe)["subsample"]} == site["dedupe"]
