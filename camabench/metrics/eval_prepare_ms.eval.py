"""Milliseconds an evaluated frame of evaluation set-up before the first
chunk: the GT store's signature check and resolution (eval_gt_refresh: a
stat and two reads per PNG) and the scene tensors, crop sizing and chunk
layout (eval_layout)."""
LAYER = "eval"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "eval_fps"
PHASES = ("eval_gt_refresh", "eval_layout")


def read(r):
    if (r.produces != "evaluated_frames" or not any(p in r.timers for p in PHASES)
            or not r.frames):
        return None
    return 1e3 * sum(r.timers.get(p, 0.0) for p in PHASES) / r.frames
