"""Milliseconds an evaluated frame of loading ground truth (the GT store's
mmap reads, or a PNG decode and remap on a miss): the evaluators'
eval_gt_load phase."""
LAYER = "eval"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "eval_fps"


def read(r):
    if r.produces != "evaluated_frames" or "eval_gt_load" not in r.timers or not r.frames:
        return None
    return 1e3 * r.timers["eval_gt_load"] / r.frames
