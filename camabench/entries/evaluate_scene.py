"""Entry kind "evaluate_scene": a pass is one
MapEvaluator(...).evaluate_scene call on a pipeline built in set-up; its
passes count evaluated frames.

Traffic keys it reads besides loops.py's: sources (the label source
evaluated) and evaluator (MapEvaluator keyword arguments).
"""
from __future__ import annotations

from camabench import check
from camabench.loops import _Loop
from camabench.reference import scene as ref_scene


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


LOOP, PRODUCES = EvalLoop, "evaluated_frames"
