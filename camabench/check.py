"""The output comparisons that decide `correct`, and their limits.

Each compared number has its limit in limits.json, with the readings the
limit was set from: the largest of sound runs of the program (lower) and
the smallest of the control, the reference computed in bfloat16 in the
program's place (upper).  A run is correct when every number it compares
is at or under its limit.
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
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


def limits(path=os.path.join(HERE, "limits.json")):
    with open(path) as f:
        return json.load(f)


def judge(numbers, table=None):
    """(correct, {name: {"value", "limit"}})."""
    table = table if table is not None else limits()
    out = {}
    for name, value in numbers.items():
        if name not in table:
            raise KeyError(f"no limit for compared number {name!r}")
        out[name] = {"value": value, "limit": table[name]["limit"]}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
