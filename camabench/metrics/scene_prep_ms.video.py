"""Milliseconds a video frame of scene preparation after a label fix:
lifting the labels or loading the scene cache (scene_compile), and the
counting pass with its sidecar store (count_pass)."""
LAYER = "cli"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"
PHASES = ("scene_compile", "count_pass")


def read(r):
    if r.produces != "video_frames" or not any(p in r.timers for p in PHASES) or not r.frames:
        return None
    return 1e3 * sum(r.timers.get(p, 0.0) for p in PHASES) / r.frames
