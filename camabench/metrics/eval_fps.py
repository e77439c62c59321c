"""Frames evaluated per second of the window by
MapEvaluator(...).evaluate_scene."""
UNIT, SOURCE = "frames/s", "host_clock"


def read(r):
    return r.frames / r.window_s if r.produces == "evaluated_frames" else None
