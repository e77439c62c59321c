"""Milliseconds an evaluated frame of waiting for the card's metric sums
and copying them (the evaluators' eval_fetch phase)."""
LAYER = "eval"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "eval_fps"


def read(r):
    if r.produces != "evaluated_frames" or "eval_fetch" not in r.timers or not r.frames:
        return None
    return 1e3 * r.timers["eval_fetch"] / r.frames
