"""Every metric reader on fixed readings of a video run and of an
evaluation run: the values they gave when the readers went by the
traffic's entry name (cli, evaluate_scene), pinned, now that they go by
what the entry kind's passes produce."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from camabench.spec import Spec

TIMERS = {"host_decode": 0.75, "host_composite": 6.125, "device_dispatch": 0.25,
          "sparse_fetch": 0.0625, "raster_fetch": 0.03125, "sink_open": 0.5,
          "sink_wait": 31.0, "sink_copy": 3.5, "sink_close": 1.25, "sink_encode": 62.0,
          "scene_compile": 0.0875, "count_pass": 0.5, "eval_gt_refresh": 20.5,
          "eval_gt_load": 14.625, "eval_dispatch": 14.0, "eval_fetch": 0.046875,
          "eval_layout": 0.375}
RUNS = {
    "video_frames": dict(setup_s=11.548, window_s=51.375, frames=2820, passes=30,
                         timers=TIMERS, trace={"busy_s": 0.0805, "window_s": 51.25},
                         least_s=0.000293),
    "evaluated_frames": dict(setup_s=17.08, window_s=51.125, frames=6392, passes=136,
                             timers=TIMERS, trace={"busy_s": 15.125, "window_s": 51.0625},
                             least_s=0.04575),
}
BARE = dict(timers={}, trace=None, least_s=None)  # an untraced run with no phases
# what each reader gave on these readings with the traffic's entry "cli" or
# "evaluate_scene"; every reader not named gave None
PINNED = {
    ("video_frames", False): {
        "device_idle.video": 99.8429268292683, "device_roofline.video": 0.36397515527950314,
        "encode_ms.video": 21.98581560283688, "fetch_ms.video": 0.03324468085106383,
        "host_composite_ms.video": 2.171985815602837, "scene_prep_ms.video": 0.20833333333333334,
        "setup_s": 11.548, "sink_ms.video": 12.854609929078014,
        "unattributed_ms.video": 15.658244680851064, "video_fps": 54.89051094890511},
    ("video_frames", True): {"setup_s": 11.548, "video_fps": 54.89051094890511},
    ("evaluated_frames", False): {
        "device_idle.eval": 70.37943696450428, "device_roofline.eval": 0.30247933884297523,
        "eval_dispatch_ms.eval": 2.1902377972465583, "eval_fetch_ms.eval": 0.007333385481852315,
        "eval_fps": 125.02689486552568, "eval_gt_load_ms.eval": 2.2880162703379225,
        "eval_prepare_ms.eval": 3.2658010012515644, "setup_s": 17.08},
    ("evaluated_frames", True): {"eval_fps": 125.02689486552568, "setup_s": 17.08},
}


READERS = ["device_idle.eval", "device_idle.video", "device_roofline.eval",
           "device_roofline.video", "encode_ms.video", "eval_dispatch_ms.eval",
           "eval_fetch_ms.eval", "eval_fps", "eval_gt_load_ms.eval", "eval_prepare_ms.eval",
           "fetch_ms.video", "host_composite_ms.video", "scene_prep_ms.video", "setup_s",
           "sink_ms.video", "unattributed_ms.video", "video_fps"]


@pytest.mark.parametrize("produces,bare", list(PINNED))
def test_readers_read_as_pinned(produces, bare):
    spec = Spec()
    r = SimpleNamespace(produces=produces, **{**RUNS[produces], **(BARE if bare else {})})
    got = {n: spec.reader({"name": n}).read(r) for n in READERS}
    assert got == {n: PINNED[produces, bare].get(n) for n in READERS}
