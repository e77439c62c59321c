"""Milliseconds a video frame spent waiting for the card's chunks and
copying them (sparse_fetch and raster_fetch phases)."""
LAYER = "pipeline"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"
PHASES = ("sparse_fetch", "raster_fetch")


def read(r):
    if r.produces != "video_frames" or not any(p in r.timers for p in PHASES) or not r.frames:
        return None
    return 1e3 * sum(r.timers.get(p, 0.0) for p in PHASES) / r.frames
