"""Entry kind "cli": a pass is one `main.py --config` run of the port
(cama_tpu_torch.cli.main) over a config file the set-up writes, every
scene's every source's video; its passes count video frames.

Every pass follows a label fix: before the pass, each scene's label files
get a fresh seeded draw (fixture.label_records: every polyline moved,
every point count kept), so the program lifts the labels and runs its
counting pass again while the frame store stays warm.

Traffic keys it reads besides loops.py's: config (keys of the config file
written for the CLI: batch_scenes, video_preset, ...) and sample_frames
(video frames kept from the window for the output check).
"""
from __future__ import annotations

import dataclasses
import json
import os

from camabench import check, fixture
from camabench.loops import _Loop, _quiet
from camabench.reference import scene as ref_scene

SUFFIX = {"cama": "cama", "nuscenes": "nuScenes"}


class VideoLoop(_Loop):
    """`main.py --config` passes: every scene's every source's video."""

    def setup(self):
        from cama_tpu_torch.pipeline import ClipPipeline
        from cama_tpu_torch.warmup import warmup_frames

        self.clip_paths = self.clips()
        self.window_draws = []
        for i, clip in enumerate(self.clip_paths):
            # a run starts from the clip as written, whatever an earlier
            # run's label fixes left, and with no compiled scene or counts
            # of any draw, so that no run finds an earlier run's work
            fixture.write_labels(clip, self.cfg, self.seed, i)
            for stale in (os.path.join(clip, ".cama_tpu", "scene_cache.npz"),
                          os.path.join(self.store_dir, os.path.basename(clip),
                                       "overlay_counts.json")):
                if os.path.exists(stale):
                    os.remove(stale)
        sources = self.cfg["label_sources"]
        self.videos = os.path.join(self.work_dir, "videos")
        config = {"converted_dataroot": self.clip_dir,
                  "scene_names": [os.path.basename(c) for c in self.clip_paths],
                  "output_video_dir": self.videos,
                  "cama_configs": self.cama_configs,
                  **self.traffic.get("config", {})}
        self.config_path = os.path.join(self.work_dir, "config.yaml")
        with open(self.config_path, "w") as f:
            json.dump(config, f)  # JSON is YAML
        self.ref = {os.path.basename(c): self.reference_clip(c, sources)
                    for c in self.clip_paths}
        self.scene_index = {os.path.basename(c): i for i, c in enumerate(self.clip_paths)}
        # sink path -> (scene, source, [image_idx of each frame written])
        self.sinks = {}
        for scene, data in self.ref.items():
            for src in sources:
                path = os.path.join(self.videos, f"{scene}_{SUFFIX[src]}.mp4")
                self.sinks[path] = (scene, src, [i for i, _ in ref_scene.served_frames(data, src)])
        if self.cama_configs.get("frame_cache", True):
            for clip in self.clip_paths:
                pipe = ClipPipeline(self.cama_configs, clip, device=self.device)
                for _ in range(5):
                    if warmup_frames(pipe)["hit_rate"] == 1.0:
                        break
                else:
                    raise RuntimeError(f"{clip}: the frame store did not fill")
                del pipe
        self.taps.expect_sinks({p: len(v[2]) for p, v in self.sinks.items()},
                               int(self.traffic.get("sample_frames", 12)), self.seed)
        self.warm()

    def run_pass(self):
        from cama_tpu_torch import cli

        draw = self.taps.begin_pass()
        with self.taps.span("label_fix"):
            for i, clip in enumerate(self.clip_paths):
                fixture.write_labels(clip, self.cfg, self.seed, i, draw)
        argv = ["--config", self.config_path, "--device", str(self.device)]
        with self.taps.span("cli.main"), _quiet():
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc}")
        frames = self.taps.end_pass()
        if self.taps.recording:
            self.window_draws.append(draw)
        return frames

    def data(self, scene, pass_no):
        """The reference's ClipData of a scene as pass `pass_no` served
        it: the labels of that pass's draw, lifted by the reference."""
        base = self.ref[scene]
        recs = fixture.label_records(self.cfg, self.seed, self.scene_index[scene], pass_no)
        points, lane = dict(base.points), dict(base.lane)
        if "map_labels.json" in recs:
            import numpy as np

            grid = np.load(os.path.join(base.path, "maps", "vision_road_mlp_ft.npy"))
            points["cama"], lane["cama"] = ref_scene.lift_cama(
                recs["map_labels.json"], grid, float(self.cfg["map_size_m"]))
        if "map_nuscenes.json" in recs:
            points["nuscenes"], lane["nuscenes"] = ref_scene.lift_nuscenes(
                recs["map_nuscenes.json"])
        return dataclasses.replace(base, points=points, lane=lane)

    def release(self):
        pass

    def check(self):
        """{"frames_gap": most frames a sink missed or added in any pass,
        "overlay_mismatch": over the sampled frames, the largest
        check.mosaic_mismatch against the reference}."""
        from camabench.reference.render import Renderer

        worst = float("inf") if not self.taps.samples() else 0.0
        renderers = {}

        def order(item):
            (path, k, p), _ = item
            return self.sinks[path][0], p, self.sinks[path][2][k]

        for (path, k, p), frame in sorted(self.taps.samples(), key=order):
            scene, src, served = self.sinks[path]
            if scene not in renderers:
                renderers = {scene: Renderer(self.ref[scene], self.cfg["crop_m"])}
            renderer = renderers[scene]
            renderer.clip = self.data(scene, p)
            worst = max(worst, check.mosaic_mismatch(frame, *renderer.mosaic(src, served[k])))
        return {"frames_gap": float(self.taps.frames_gap()), "overlay_mismatch": worst}

    def control(self, dtype):
        """overlay_mismatch of the reference computed in `dtype`, put in the
        program's place, on the frames the window sampled."""
        from camabench.reference.render import Renderer

        worst = 0.0
        for (path, k, p) in sorted({key for key, _ in self.taps.samples()}):
            scene, src, served = self.sinks[path]
            data = self.data(scene, p)
            ref = Renderer(data, self.cfg["crop_m"])
            ctl = Renderer(data, self.cfg["crop_m"], dtype)
            worst = max(worst, check.mosaic_mismatch(ctl.mosaic(src, served[k])[0],
                                                     *ref.mosaic(src, served[k])))
        return {"overlay_mismatch": worst}

    def work(self):
        """[(source, points, frames [(crop count, [C] kept, [C] kept after
        dedup)])] of every pass of the window, at float64.  The counts are
        those of the window's first draw for every pass: the draws move the
        labels by a few metres and keep every point count, and the least
        time is bound by the points' bytes, which do not change."""
        from camabench.reference.render import counts

        if not self.window_draws:
            return []
        one = []
        for scene in self.ref:
            data = self.data(scene, self.window_draws[0])
            for src in self.cfg["label_sources"]:
                pts = data.points[src]
                frames = [counts(pts, pose, data, self.cfg["crop_m"])
                          for _, pose in ref_scene.served_frames(data, src)]
                one.append((src, len(pts), frames))
        return one * len(self.window_draws)


LOOP, PRODUCES = VideoLoop, "video_frames"
