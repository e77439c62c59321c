"""Milliseconds of encoder time a video frame: the encoder threads' busy
time writing frames to the backend (the program's sink_encode), over the
frames.  Sinks encode in parallel, so it can exceed the wall time a
frame."""
LAYER = "io/video"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"


def read(r):
    if r.entry != "cli" or "sink_encode" not in r.timers or not r.frames:
        return None
    return 1e3 * r.timers["sink_encode"] / r.frames
