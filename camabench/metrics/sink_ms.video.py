"""Milliseconds a video frame that the producer spends in the video sinks:
opening the encoders, waiting for a free buffer (the encoders'
back-pressure), copying the frame and closing the sinks (the drain of the
last frames and the mp4's finish): the program's sink_open, sink_wait,
sink_copy and sink_close phases."""
LAYER = "io/video"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"
PHASES = ("sink_open", "sink_wait", "sink_copy", "sink_close")


def read(r):
    if r.entry != "cli" or not any(p in r.timers for p in PHASES) or not r.frames:
        return None
    return 1e3 * sum(r.timers.get(p, 0.0) for p in PHASES) / r.frames
