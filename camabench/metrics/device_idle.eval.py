"""Share of the traced window in which no kernel, memset or copy ran on
the card (torch.profiler)."""
LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "eval_fps"


def read(r):
    if r.produces != "evaluated_frames" or r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
