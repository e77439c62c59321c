"""Milliseconds a video frame of host compositing (the native compositor
painting onto the base images in the mosaic): the pipelines'
host_composite phase over the window."""
LAYER = "native compositor"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"


def read(r):
    if r.produces != "video_frames" or "host_composite" not in r.timers or not r.frames:
        return None
    return 1e3 * r.timers["host_composite"] / r.frames
