"""The least time the card could take for the window's work (work.py,
from the cell's shapes) over the time it was busy (torch.profiler), in %."""
LAYER = "kernels"
UNIT, SOURCE, MOVES = "%", "device_trace", "video_fps"


def read(r):
    if r.produces != "video_frames" or r.trace is None or r.least_s is None:
        return None
    return 100.0 * r.least_s / r.trace["busy_s"]
