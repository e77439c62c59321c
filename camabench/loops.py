"""The closed loop of a traffic file: reads its parameters and runs the
program's user entry it names, one pass at a time.

A traffic file (traffic/<name>.json) holds:

  entry          "cli": one `main.py --config` run of the port
                 (cama_tpu_torch.cli.main) over a generated config;
                 "evaluate_scene": one MapEvaluator(...).evaluate_scene
                 call on a pipeline built in set-up
  scenes         scenes a pass serves, seeds derived from --seed
  sources        "evaluate_scene": the label source evaluated ("cli"
                 writes a video of every source the configuration's
                 scenes carry, its label_sources)
  needs          "images" (camera JPEGs) and/or "gt_masks"
  gt             ground-truth drawing: shift_px, drop_instances
  config         keys of the config file written for the CLI
                 (batch_scenes, video_preset, ...)
  cama_configs   cama_configs keys passed to the program
  evaluator      MapEvaluator keyword arguments
  sample_frames  video frames kept from the window for the output check
  warm_passes    passes run in set-up before the window
  device_output  the output the yardstick counts for the card's work:
                 "lists" (the sparse point lists), "packed_rasters" or
                 "gt_masks" (the evaluation's fields and sums)

Every "cli" pass follows a label fix: before the pass, each scene's label
files get a fresh seeded draw (fixture.label_records: every polyline moved,
every point count kept), so the program lifts the labels and runs its
counting pass again while the frame store stays warm.

A loop's set-up writes the fixtures, fills the program's stores and
runs the warm passes; `run_pass` runs one pass and returns the frames it
produced; `release` drops the program's state; `check` compares what the
window produced with the reference and returns each compared number;
`work` gives the window's work for the yardstick (work.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os

from camabench import check, fixture
from camabench.reference import scene as ref_scene

SUFFIX = {"cama": "cama", "nuscenes": "nuScenes"}


def make(cell, cfg, traffic, seed, device, cache_root, work_dir, taps):
    kinds = {"cli": VideoLoop, "evaluate_scene": EvalLoop}
    if traffic["entry"] not in kinds:
        raise ValueError(f"unknown traffic entry {traffic['entry']!r}")
    return kinds[traffic["entry"]](cell, cfg, traffic, seed, device, cache_root,
                                   work_dir, taps)


@contextlib.contextmanager
def _quiet():
    """The program's progress lines go nowhere: the result is the last
    line of standard output."""
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


class _Loop:
    def __init__(self, cell, cfg, traffic, seed, device, cache_root, work_dir, taps):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = int(seed), device
        self.cache_root, self.work_dir, self.taps = cache_root, work_dir, taps
        self.store_dir = os.path.join(cache_root, cell, "store")
        self.seed_dir = os.path.join(cache_root, cfg["name"], "seeds", str(self.seed))
        self.output_size = (int(cfg["output_height"]), int(cfg["output_width"]))
        self.cama_configs = {"frame_cache_dir": self.store_dir,
                             **traffic.get("cama_configs", {})}

    def clips(self):
        """Clip paths of the pass's scenes, written when not cached."""
        needs = self.traffic.get("needs", [])
        out = []
        for i in range(int(self.traffic["scenes"])):
            clip = os.path.join(self.seed_dir, f"scene-{i:04d}")
            done = clip + ".complete"
            if not os.path.exists(done):
                images = (fixture.ensure_images(self.cache_root, self.cfg, i)
                          if "images" in needs else None)
                fixture.write_clip(self.seed_dir, self.cfg, self.seed, i, images)
                if "gt_masks" in needs:
                    fixture.write_gt_masks(clip, self.cfg, self.seed, self.traffic["gt"])
                open(done, "w").close()
            out.append(clip)
        return out

    def reference_clip(self, clip, sources):
        return ref_scene.load_clip(clip, self.cfg["cameras"], self.output_size,
                                   tuple(sources), float(self.cfg["map_size_m"]))

    def warm(self):
        for _ in range(int(self.traffic.get("warm_passes", 1))):
            self.run_pass()


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
        config = {"converted_dataroot": self.seed_dir,
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


class EvalLoop(_Loop):
    """MapEvaluator(...).evaluate_scene passes over one pipeline."""

    def setup(self):
        from cama_tpu_torch.pipeline import ClipPipeline

        (clip,) = self.clips()
        self.source = self.traffic["sources"][0]
        self.ref_data = self.reference_clip(clip, [self.source])
        self.pipe = ClipPipeline(self.cama_configs, clip, device=self.device)
        self.results = []
        served = [i for i, _ in ref_scene.served_frames(self.ref_data, self.source)]
        for _ in range(5):
            self.run_pass()
            cache = self.pipe.gt_mask_cache()
            cache.flush()
            if all(cache.get(i, c) is not None for i in served
                   for c in range(len(self.cfg["cameras"]))):
                break
        else:
            raise RuntimeError(f"{clip}: the ground-truth store did not fill")
        self.warm()
        self.results = []

    def run_pass(self):
        from cama_tpu_torch.eval.map_metrics import MapEvaluator

        with self.taps.span("evaluate_scene"):
            out = MapEvaluator(**self.traffic.get("evaluator", {})).evaluate_scene(
                self.pipe, self.source)
        self.results.append(out)
        return int(out["frames_evaluated"])

    def release(self):
        self.pipe = None

    def reference(self, dtype=None):
        import torch

        from camabench.reference.evaluate import evaluate

        kw = self.traffic.get("evaluator", {})
        return evaluate(self.ref_data, self.source, self.cfg["crop_m"],
                        tolerance=kw.get("tolerance", 5),
                        max_radius=kw.get("max_radius", 20),
                        dtype=dtype or torch.float64)

    def check(self):
        """{"frames_gap": most frames evaluated off the reference's count,
        "eval_gap": over every pass, the largest check.eval_gap}."""
        ref = self.reference()
        if not self.results:
            return {"frames_gap": float("inf"), "eval_gap": float("inf")}
        return {"frames_gap": max(float(abs(out["frames_evaluated"] - ref["frames_evaluated"]))
                                  for out in self.results),
                "eval_gap": max(check.eval_gap(out, ref) for out in self.results)}

    def control(self, dtype):
        """eval_gap of the reference computed in `dtype`, put in the
        program's place."""
        return {"eval_gap": check.eval_gap(self.reference(dtype), self.reference())}

    def work(self):
        from camabench.reference.render import counts

        pts = self.ref_data.points[self.source]
        frames = [counts(pts, pose, self.ref_data, self.cfg["crop_m"])
                  for _, pose in ref_scene.served_frames(self.ref_data, self.source)]
        # every pass of the window evaluates the same labels
        return [(self.source, len(pts), frames)] * len(self.results)
