"""Entry kind "sites": a pass is one `main.py --config` run of the port
(cama_tpu_torch.cli.main) over the member clips of a CAMAv2 site with a
`sites:` block naming them all: every member's own video of each label
source, then the site merged (Sim(3) per member, refinement, dedupe),
`<site>_labels.json`, and every member's video re-rendered from the merged
map.  Its passes count video frames.

Every pass follows a label fix: before the pass, every member's
map_labels.json is redrawn with the whole network moved by one seeded
offset (site_fixture.draw_offset), so lifting, the Sim(3)s, the refinement
and the dedupe all run again on new inputs.

While the loop runs, `cama_tpu_torch.aggregate.site.Site` is a tapping
subclass that records, for the pass, each member's Sim(3) as `add_clip`
estimated it, and of the site `from_clips` returns its instances, each
member's refined Sim(3), `refine_losses` (the refinement's objective at
the start of each Adam step) and the `site_refine_steps` and
`site_refine_pairs` counters of `Site.timers`; it changes nothing.  A
program whose Site lacks `timers` or `refine_losses` cannot be
checked, and set-up stops at once.

The output check holds each member's frames against the reference render
of that pass's draw, each site frame against the reference projection and
painting of the program's own merged map through the program's own Sim(3)
of that member, and one seeded pass's site against the reference site
(reference/site.py) of that pass's labels:

- site_frame_gap: how far, in metres, the Sim(3)s the program estimated
  before the refinement, and member 0's refined one (the refinement holds
  member 0), put any of the member's lifted points from where the
  reference's Umeyama puts it: this fixes the world frame the whole site
  shares;
- site_refine_gap: inf unless the refinement ran the configured steps
  over the reference's candidate pairs; else the relative gap of its
  objective before the first step from the float64 refinement's;
- site_map_gap: the largest xy distance between corresponding points of
  the program's merged map and the reference's map through the program's
  own refined Sim(3)s, kept by the reference's dedupe (inf where other
  instances are kept);
- site_loss_gap: how far the refinement's objective at the program's
  Sim(3)s exceeds the objective at the float64 refinement's own.

The program's float32 refinement and the float64 one part by rounding
after ~50 of their 600 Adam steps and land 0.15-0.5 m apart, and either
may keep duplicates the other drops (PERF.md §6): so the map and its kept
set are held to the program's own Sim(3)s exactly, the refinement by its
step and pair counts and the objective it starts from, and the Sim(3)s it
ends at by the objective they reach.  Its path between is not held:
Adam's first step moves every parameter by about the learning rate
whatever the size of its gradient, so a component whose gradient is near
zero (roll and pitch on a flat road) takes its sign from rounding, and
the objective after a few steps reads up to 2.4 % off the float64 one.

The scenes a pass serves are the configuration's site members
(site.clips), not the traffic's `scenes`.  Traffic keys it reads besides
loops.py's: config (keys of the config file written for the CLI), site
({"name", "refine"} of the `sites:` entry) and sample_frames.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

from camabench import check, fixture, site_fixture
from camabench.loops import _Loop, _marker, _quiet
from camabench.reference import scene as ref_scene
from camabench.reference import site as ref_site


class SiteLoop(_Loop):
    """`main.py --config` passes over a site's members with a `sites:`
    block."""

    def clips(self):
        """Member clip paths, written when not cached (loops._Loop.clips's
        marker rule)."""
        grid = site_fixture.ensure_grid(self.cache_root, self.cfg)
        out = []
        for i, member in enumerate(self.members):
            clip = os.path.join(self.clip_dir, f"scene-{i:04d}")
            done = clip + ".complete"
            if _marker(done) != self.fixtures:
                images = fixture.ensure_images(self.cache_root, self.cfg, i)
                site_fixture.write_clip(self.clip_dir, self.cfg, self.seed, member, images,
                                        grid)
                with open(done, "w") as f:
                    json.dump(self.fixtures, f)
            out.append(clip)
        return out

    def setup(self):
        import cama_tpu_torch.aggregate.site as site_mod
        from cama_tpu_torch.pipeline import ClipPipeline
        from cama_tpu_torch.warmup import warmup_frames

        probe = site_mod.Site(device="cpu")
        if not (hasattr(probe, "timers") and hasattr(probe, "refine_losses")):
            raise RuntimeError("the program's Site does not report its refinement's steps "
                               "and objective (Site.timers, Site.refine_losses), which the "
                               "site_video check holds")
        n = int(self.cfg["site"]["clips"])
        self.members = [site_fixture.SiteClip(self.cfg, self.seed, i) for i in range(n)]
        self.clip_paths = self.clips()
        self.names = [os.path.basename(c) for c in self.clip_paths]
        for member, clip in zip(self.members, self.clip_paths):
            # a run starts from the clips as written, with no compiled scene
            # or counts of any draw
            site_fixture.write_labels(clip, member, self.cfg, self.seed)
            for stale in (os.path.join(clip, ".cama_tpu", "scene_cache.npz"),
                          os.path.join(clip, ".cama_tpu", "scene_cache_cama.npz"),
                          os.path.join(self.store_dir, os.path.basename(clip),
                                       "overlay_counts.json")):
                if os.path.exists(stale):
                    os.remove(stale)
        self.site_name = self.traffic["site"]["name"]
        self.videos = os.path.join(self.work_dir, "videos")
        config = {"converted_dataroot": self.clip_dir, "scene_names": self.names,
                  "output_video_dir": self.videos, "cama_configs": self.cama_configs,
                  **self.traffic.get("config", {}),
                  "sites": [{"name": self.site_name, "scenes": self.names,
                             "refine": bool(self.traffic["site"]["refine"])}]}
        self.config_path = os.path.join(self.work_dir, "config.yaml")
        with open(self.config_path, "w") as f:
            json.dump(config, f)  # JSON is YAML
        self.ref = {name: self.reference_clip(c, ["cama"])
                    for name, c in zip(self.names, self.clip_paths)}
        # sink path -> (scene, source, [image_idx of each frame written])
        self.sinks = {}
        for name, data in self.ref.items():
            served = [i for i, _ in ref_scene.served_frames(data, "cama")]
            self.sinks[os.path.join(self.videos, f"{name}_cama.mp4")] = (name, "cama", served)
            self.sinks[os.path.join(self.videos, f"{self.site_name}_{name}_site.mp4")] = (
                name, "site", served)
        for clip in self.clip_paths:
            pipe = ClipPipeline(self.cama_configs, clip, device=self.device)
            for _ in range(5):
                if warmup_frames(pipe)["hit_rate"] == 1.0:
                    break
            else:
                raise RuntimeError(f"{clip}: the frame store did not fill")
            del pipe
        self.taps.expect_sinks({p: len(v[2]) for p, v in self.sinks.items()},
                               int(self.traffic.get("sample_frames", 16)), self.seed)
        self.window_draws = []
        self.sites = {}  # pass -> what the tap recorded of the program's site
        self._draw = None
        self._tap_site()
        self.warm()

    def _tap_site(self):
        """Put the recording subclass where `_run_sites` looks Site up."""
        import cama_tpu_torch.aggregate.site as site_mod

        loop, base = self, site_mod.Site

        class TapSite(base):
            def add_clip(self, clip_path, scene):
                super().add_clip(clip_path, scene)
                self.__dict__.setdefault("tap_initial", []).append(self.clips[-1][2])

            @classmethod
            def from_clips(cls, *args, **kwargs):
                site = super().from_clips(*args, **kwargs)
                loop.sites[loop._draw] = {
                    "instances": list(site.instances),
                    "sim3": [sim3 for _, _, sim3 in site.clips],
                    "initial": list(getattr(site, "tap_initial", [])),
                    "losses": np.asarray(site.refine_losses, np.float64),
                    "steps": int(site.timers.count.get("site_refine_steps", 0)),
                    "pairs": int(site.timers.count.get("site_refine_pairs", 0))}
                return site

        self._site_original = (site_mod, base)
        site_mod.Site = TapSite

    def release(self):
        if getattr(self, "_site_original", None):
            site_mod, base = self._site_original
            site_mod.Site = base
            self._site_original = None

    def run_pass(self):
        from cama_tpu_torch import cli

        draw = self.taps.begin_pass()
        self._draw = draw
        with self.taps.span("label_fix"):
            for member, clip in zip(self.members, self.clip_paths):
                site_fixture.write_labels(clip, member, self.cfg, self.seed, draw)
        argv = ["--config", self.config_path, "--device", str(self.device)]
        with self.taps.span("cli.main"), _quiet():
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc}")
        frames = self.taps.end_pass()
        if self.taps.recording:
            self.window_draws.append(draw)
        else:
            self.sites.pop(draw, None)
        return frames

    # ---------------- the reference ----------------

    def labels(self, index, draw):
        offset = site_fixture.draw_offset(self.cfg, self.seed, draw)
        return self.members[index].label_records(offset)

    def data(self, scene, draw):
        """The reference's ClipData of a member as pass `draw` served it:
        its own labels of that draw, lifted, and, where the program
        returned a site that pass, the program's merged map in the
        member's frame as source "site"."""
        i = self.names.index(scene)
        base = self.ref[scene]
        grid = np.load(os.path.join(base.path, "maps", "vision_road_mlp_ft.npy"))
        points, lane = dict(base.points), dict(base.lane)
        points["cama"], lane["cama"] = ref_scene.lift_cama(
            self.labels(i, draw), grid, float(self.cfg["map_size_m"]))
        tables = dict(base.pose_table)
        if draw in self.sites:
            rec = self.sites[draw]
            points["site"], lane["site"] = ref_site.member_points(rec["instances"],
                                                                 rec["sim3"][i])
            tables["site"] = tables["cama"]
        return dataclasses.replace(base, points=points, lane=lane, pose_table=tables)

    def reference_members(self, draw):
        """reference/site.Member of every member with the labels of `draw`."""
        return [ref_site.Member(c, self.cfg, labels=self.labels(i, draw))
                for i, c in enumerate(self.clip_paths)]

    def reference_site(self, members, dtype=None):
        """reference/site.build of `members`."""
        import torch

        return ref_site.build(members, self.cfg, self.device, dtype or torch.float64,
                              refine_it=bool(self.traffic["site"]["refine"]))

    def loss_gap(self, sim3, members, ref):
        """site_loss_gap of refined Sim(3)s `sim3`: the refinement's
        objective (float64, the reference's candidate pairs) at the
        members' instances moved by them, over the objective at the
        reference's own refined map, less 1 (0 without a refinement)."""
        if "pairs" not in ref:
            return 0.0
        S = self.cfg["site"]["refine"]["subsample"]
        at = ref_site.objective(ref_site.moved(members, sim3), *ref["pairs"], S, self.device)
        return at / ref_site.objective(ref["refined"], *ref["pairs"], S, self.device) - 1.0

    def program_map(self, sim3, members):
        """(refined, keep) of refined Sim(3)s `sim3`: every instance of
        `members` moved by them (float64), and what the reference's dedupe
        keeps of that map."""
        dd = self.cfg["site"]["dedupe"]
        refined = ref_site.moved(members, sim3)
        return refined, ref_site.dedupe_keep(refined, dd["tol_m"], dd["subsample"],
                                             self.device)[0]

    def frame_gap(self, initial, held, members, ref):
        """site_frame_gap of Sim(3)s `initial` (one a member, before the
        refinement) and `held` (member 0's after it): the largest distance,
        in metres, at which they put a member's lifted points from where the
        reference site `ref`'s Sim(3)s (its Umeyama, and its member 0 after
        the refinement) put them; inf for another number of members."""
        if len(initial) != len(members):
            return float("inf")
        worst = 0.0
        for member, a, b in [*zip(members, initial, ref["sim3_initial"]),
                             (members[0], held, ref["sim3"][0])]:
            if not member.instances:
                continue
            p = np.concatenate([q for _, q in member.instances])
            (Ra, ta, sa), (Rb, tb, sb) = a, b
            moved = [s * (p @ np.asarray(R, np.float64).T) + np.asarray(t, np.float64)
                     for R, t, s in ((Ra, ta, sa), (Rb, tb, sb))]
            worst = max(worst, float(np.linalg.norm(moved[0] - moved[1], axis=1).max()))
        return worst

    def refine_gap(self, losses, steps, pairs, ref):
        """site_refine_gap of a refinement that ran `steps` Adam steps
        (its counter) over `pairs` candidate pairs with the objective
        `losses` at the start of each: inf unless it ran the configured
        steps over the reference site `ref`'s pairs; else the relative gap
        of its objective before the first step from the float64
        refinement's (0 without a refinement)."""
        losses = np.asarray(losses, np.float64)
        want = int(self.cfg["site"]["refine"]["iters"]) if ref["refine_pairs"] else 0
        if (steps, len(losses), pairs) != (want, want, ref["refine_pairs"]):
            return float("inf")
        return abs(float(losses[0]) / float(ref["losses"][0]) - 1.0) if want else 0.0

    def map_gap(self, kept, sim3, members):
        """site_map_gap of a merged map `kept` [(class, points, member)]
        whose members' refined Sim(3)s are `sim3`: the largest xy distance
        to the reference's map of `members` through the same Sim(3)s, kept
        by the reference's dedupe; inf where `kept` holds other
        instances."""
        return ref_site.map_gap(kept, *self.program_map(sim3, members))

    def _checked_pass(self):
        """The window's pass whose merged map is compared, drawn from the
        seed."""
        rng = np.random.default_rng([self.seed, 1])
        return self.window_draws[int(rng.integers(len(self.window_draws)))]

    def _sample_mismatch(self, dtype=None):
        """The largest check.mosaic_mismatch over the sampled frames, of the
        program's frames (dtype None) or of the reference's projection in
        `dtype` put in the program's place."""
        from camabench.reference.render import Renderer

        worst = float("inf") if not self.taps.samples() else 0.0
        renderers = {}

        def order(item):
            (path, k, p), _ = item
            return self.sinks[path][0], p, self.sinks[path][2][k]

        for (path, k, p), frame in sorted(self.taps.samples(), key=order):
            scene, src, served = self.sinks[path]
            data = self.data(scene, p)
            if src not in data.points:
                return float("inf")  # the pass returned no site
            if scene not in renderers:
                renderers = {scene: Renderer(data, self.cfg["crop_m"])}
            ref = renderers[scene]
            ref.clip = data
            if dtype is not None:
                frame = Renderer(data, self.cfg["crop_m"], dtype).mosaic(src, served[k])[0]
            worst = max(worst, check.mosaic_mismatch(frame, *ref.mosaic(src, served[k])))
        return worst

    def _labels_json_gap(self):
        """0 when the last pass's `<site>_labels.json` holds the xy of the
        merged map the program returned that pass, else inf."""
        path = os.path.join(self.videos, f"{self.site_name}_labels.json")
        last = self.window_draws[-1] if self.window_draws else None
        if last not in self.sites or not os.path.exists(path):
            return float("inf")
        with open(path) as f:
            records = json.load(f)
        kept = self.sites[last]["instances"]
        written = [(r["attrs"]["type"], r["data"], m) for r, (_, _, m) in zip(records, kept)]
        gap = ref_site.map_gap(written, kept, [True] * len(kept))
        return 0.0 if len(records) == len(kept) and gap <= 1e-9 else float("inf")

    def check(self):
        """{"frames_gap", "overlay_mismatch", "site_frame_gap",
        "site_refine_gap", "site_map_gap", "site_loss_gap"}: the frames each
        sink missed or added in any pass; over the sampled frames the
        largest check.mosaic_mismatch against the reference; for one seeded
        pass, site_frame_gap (frame_gap), site_refine_gap (refine_gap),
        site_map_gap (map_gap; inf also where the last pass's labels file
        does not hold the map the program returned) and site_loss_gap
        (loss_gap) against the reference site of that pass's labels.  The
        distance from the
        program's map to the float64 refinement's own goes to standard
        error: two refinements that part by rounding land up to ~0.5 m
        apart (PERF.md §6), so it is read, not judged."""
        out = {"frames_gap": float(self.taps.frames_gap()),
               "overlay_mismatch": self._sample_mismatch(),
               "site_frame_gap": float("inf"), "site_refine_gap": float("inf"),
               "site_map_gap": float("inf"), "site_loss_gap": float("inf")}
        if self.window_draws and self._checked_pass() in self.sites:
            members = self.reference_members(self._checked_pass())
            rec = self.sites[self._checked_pass()]
            kept, sim3 = rec["instances"], rec["sim3"]
            refined, keep = self.program_map(sim3, members)
            out["site_map_gap"] = max(ref_site.map_gap(kept, refined, keep),
                                      self._labels_json_gap())
            ref = self.reference_site(members)
            out["site_frame_gap"] = self.frame_gap(rec["initial"], sim3[0], members, ref)
            out["site_refine_gap"] = self.refine_gap(rec["losses"], rec["steps"],
                                                     rec["pairs"], ref)
            out["site_loss_gap"] = self.loss_gap(sim3, members, ref)
            print(f"site: the program's map {ref_site.map_gap(kept, ref['refined'], keep)!r} "
                  f"m from the float64 refinement's, kept {len(kept)}, the reference "
                  f"{len(ref['instances'])}", file=sys.stderr)
        return out

    def control(self, dtype):
        """overlay_mismatch of the reference's projection in `dtype` on the
        sampled frames; site_refine_gap, site_map_gap and site_loss_gap of
        the reference site whose refinement and transforms run in `dtype`;
        site_frame_gap of the reference's Umeyama in float32, the step below
        the float64 the configuration states for it; each put in the
        program's place."""
        members = self.reference_members(self._checked_pass())
        ref, ctl = self.reference_site(members), self.reference_site(members, dtype)
        umeyama32 = [m.sim3_to_world(np.float32) for m in members]
        return {"overlay_mismatch": self._sample_mismatch(dtype),
                "site_frame_gap": self.frame_gap(umeyama32, umeyama32[0], members, ref),
                "site_refine_gap": self.refine_gap(ctl["losses"], len(ctl["losses"]),
                                                   ctl["refine_pairs"], ref),
                "site_map_gap": self.map_gap(ctl["instances"], ctl["sim3"], members),
                "site_loss_gap": self.loss_gap(ctl["sim3"], members, ref)}

    def work(self):
        """[(source, points, frames [(crop count, [C] kept, [C] kept after
        dedup, *chamfer)])] of every pass of the window, at float64, from
        the window's first pass for every pass (the label fixes move the
        whole network and keep every count): each member's own frames and
        its site frames of the program's merged map.  The first record of
        a pass also carries the pass's chamfer work (outputs/
        site_rasters.py): (refinement pairs, subsample, steps, dedupe
        pairs, subsample), the pairs counted by the reference's prefilter,
        the dedupe's on the instances moved by the program's refined
        Sim(3)s."""
        from camabench.reference.render import counts

        first = self.window_draws[0] if self.window_draws else None
        if first not in self.sites:
            return []
        site = self.cfg["site"]
        members = self.reference_members(first)
        initial = ref_site.moved(members, [m.sim3_to_world() for m in members])
        refined = ref_site.moved(members, self.sites[first]["sim3"])
        refine = bool(self.traffic["site"]["refine"])
        ref_pairs = (len(ref_site.candidate_pairs(initial, site["refine"]["subsample"],
                                                  site["refine"]["tol_m"])[2])
                     if refine else 0)
        dd_pairs = len(ref_site.candidate_pairs(refined, site["dedupe"]["subsample"],
                                                site["dedupe"]["tol_m"])[2])
        chamfer = (ref_pairs, int(site["refine"]["subsample"]),
                   int(site["refine"]["iters"]) if refine else 0,
                   dd_pairs, int(site["dedupe"]["subsample"]))
        one = []
        for name in self.names:
            data = self.data(name, first)
            for src in ("cama", "site"):
                pts = data.points[src]
                frames = [counts(pts, pose, data, self.cfg["crop_m"])
                          for _, pose in ref_scene.served_frames(data, "cama")]
                one.append((src, len(pts), frames))
        one[0] = (one[0][0], one[0][1], [one[0][2][0] + chamfer] + one[0][2][1:])
        return one * len(self.window_draws)


LOOP, PRODUCES = SiteLoop, "video_frames"
