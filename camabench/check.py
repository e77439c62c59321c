"""The output comparisons that decide `correct`, and their limits.

Each compared number has its limit in limits/<name>.json (Spec.limit),
with the readings the limit was set from: the largest of sound runs of
the program (lower) and the smallest of the control, the reference
computed in bfloat16 in the program's place (upper).  A run is correct
when every number it compares is at or under its limit.
"""
from __future__ import annotations

import numpy as np

EVAL_KEYS = ("SRE", "precision", "recall", "f1", "n_points", "gt_pixels")


def mosaic_mismatch(frame, ref, painted):
    """Pixels of `frame` more than 3 levels off `ref` in any channel, per
    pixel the reference paints: base pixels agree to rounding, so a
    misplaced, missing or extra label point counts, and so does a wrong
    base image."""
    off = np.abs(frame.astype(np.int16) - ref.astype(np.int16)).max(-1) > 3
    return float(off.sum()) / max(int(painted.sum()), 1)


def eval_gap(out, ref):
    """The largest relative gap of the scene metrics and counts."""
    return max(abs(float(out[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-12)
               for k in EVAL_KEYS)


def judge(numbers, spec):
    """(correct, {name: {"value", "limit"}}), each number's limit found by
    its name (spec.limit, which raises on a number that has none)."""
    out = {name: {"value": value, "limit": spec.limit(name)["limit"]}
           for name, value in numbers.items()}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
