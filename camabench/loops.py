"""The closed loop of a traffic file: reads its parameters and runs the
program's user entry it names, one pass at a time.

A traffic file (traffic/<name>.json) holds:

  entry          the entry kind: entries/<entry>.py (Spec.entry), whose
                 LOOP runs a pass and whose PRODUCES names what its passes
                 count ("video_frames" or "evaluated_frames"), which the
                 metric readers go by.  "cli": one `main.py --config` run
                 of the port (cama_tpu_torch.cli.main) over a generated
                 config; "evaluate_scene": one
                 MapEvaluator(...).evaluate_scene call on a pipeline built
                 in set-up
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
                 outputs/<name>.py (Spec.output), such as "lists" (the
                 sparse point lists), "packed_rasters" or "gt_masks" (the
                 evaluation's fields and sums)

A new entry kind, compared number or device output is a new file:
entries/<entry>.py, limits/<name>.json (each number a loop's check
returns; check.judge), outputs/<name>.py (work.frame_work).

A loop's set-up writes the fixtures, fills the program's stores and
runs the warm passes; `run_pass` runs one pass and returns the frames it
produced; `release` drops the program's state; `check` compares what the
window produced with the reference and returns each compared number;
`work` gives the window's work for the yardstick (work.py).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os

from camabench import fixture
from camabench.reference import scene as ref_scene


def make(spec, cell, cfg, traffic, seed, device, cache_root, work_dir, taps):
    """The loop of the traffic's entry kind, with `produces` set from it."""
    kind = spec.entry(traffic["entry"])
    loop = kind.LOOP(cell, cfg, traffic, seed, device, cache_root, work_dir, taps)
    loop.produces = kind.PRODUCES
    return loop


@contextlib.contextmanager
def _quiet():
    """The program's progress lines go nowhere: the result is the last
    line of standard output."""
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def fixture_set(traffic):
    """(directory name, marker record) of the fixtures a traffic's clips
    hold: its needs, and the ground-truth drawing where it needs masks."""
    needs = sorted(traffic.get("needs", []))
    record = {"needs": needs}
    name = "+".join(needs) or "none"
    if "gt_masks" in needs:
        record["gt"] = traffic["gt"]
        canon = json.dumps(traffic["gt"], sort_keys=True, separators=(",", ":"))
        name += "-" + hashlib.sha256(canon.encode()).hexdigest()[:12]
    return name, record


class _Loop:
    def __init__(self, cell, cfg, traffic, seed, device, cache_root, work_dir, taps):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = int(seed), device
        self.cache_root, self.work_dir, self.taps = cache_root, work_dir, taps
        self.store_dir = os.path.join(cache_root, cell, "store")
        # a clip lies under the fixtures it holds, so that cells of one
        # configuration whose traffic needs other fixtures (camera images,
        # ground-truth masks of another drawing) never share a clip
        key, self.fixtures = fixture_set(traffic)
        self.clip_dir = os.path.join(cache_root, cfg["name"], "seeds", str(self.seed), key)
        self.output_size = (int(cfg["output_height"]), int(cfg["output_width"]))
        self.cama_configs = {"frame_cache_dir": self.store_dir,
                             **traffic.get("cama_configs", {})}

    def clips(self):
        """Clip paths of the pass's scenes, written when not cached: a clip
        is cached when its marker records the fixtures the traffic needs."""
        needs = self.fixtures["needs"]
        out = []
        for i in range(int(self.traffic["scenes"])):
            clip = os.path.join(self.clip_dir, f"scene-{i:04d}")
            done = clip + ".complete"
            if _marker(done) != self.fixtures:
                images = (fixture.ensure_images(self.cache_root, self.cfg, i)
                          if "images" in needs else None)
                fixture.write_clip(self.clip_dir, self.cfg, self.seed, i, images)
                if "gt_masks" in needs:
                    fixture.write_gt_masks(clip, self.cfg, self.seed, self.traffic["gt"])
                with open(done, "w") as f:
                    json.dump(self.fixtures, f)
            out.append(clip)
        return out

    def reference_clip(self, clip, sources):
        return ref_scene.load_clip(clip, self.cfg["cameras"], self.output_size,
                                   tuple(sources), float(self.cfg["map_size_m"]))

    def warm(self):
        for _ in range(int(self.traffic.get("warm_passes", 1))):
            self.run_pass()


def _marker(path):
    """The fixture record a clip's marker holds, None where it has none."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None
