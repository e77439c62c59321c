"""Milliseconds a video frame of the window outside every pipeline phase:
the encoders' back-pressure, opening and closing the sinks, and the CLI's
scene preparation (config, scene cache, pipelines)."""
LAYER = "io/video and cli"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"
PHASES = ("host_decode", "host_composite", "device_dispatch", "sparse_fetch",
          "raster_fetch")


def read(r):
    if r.produces != "video_frames" or "host_composite" not in r.timers or not r.frames:
        return None
    return 1e3 * (r.window_s - sum(r.timers.get(p, 0.0) for p in PHASES)) / r.frames
