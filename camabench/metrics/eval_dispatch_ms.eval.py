"""Milliseconds an evaluated frame of the host enqueueing the card's work
(projection, distance field, sums): the evaluators' eval_dispatch phase."""
LAYER = "eval"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "eval_fps"


def read(r):
    if r.produces != "evaluated_frames" or "eval_dispatch" not in r.timers or not r.frames:
        return None
    return 1e3 * r.timers["eval_dispatch"] / r.frames
