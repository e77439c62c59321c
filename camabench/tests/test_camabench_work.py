"""The yardstick: the least time of a window's work for each kind of
device output, from a cell's shapes."""
from __future__ import annotations

import pytest

from camabench import work
from camabench.spec import Spec

CARD = "NVIDIA H100 80GB HBM3"
FRAME = (33428, [1267, 23798, 646, 864, 369, 0], [835, 3041, 351, 718, 201, 0])
WIDE = (253952, [9000, 120, 0, 0, 77, 5], [4000, 100, 0, 0, 60, 5])
# (bytes, operations) of FRAME at 41,600 points and 540x960, of WIDE at
# 253,952 points and 540x962, and least seconds of three passes of 47
# FRAMEs, as work.py gave them when it held each output's arithmetic
PINNED = {
    "lists": ((561761, 5486664), (3318413, 40378368), 2.3644268955223953e-05),
    "packed_rasters": ((1318753, 5486664), (4082569, 40378368), 5.550572328358218e-05),
    "gt_masks": ((19203573, 61581640), (22003029, 96519016), 0.0008082697889552239),
}


@pytest.mark.parametrize("output", ["lists", "packed_rasters", "gt_masks"])
def test_least_seconds(output):
    out = Spec().output(output)
    one = [("cama", 41600, [FRAME] * 47)]
    t1 = work.least_seconds(one, (540, 960), out, CARD)
    assert t1 > 0
    assert work.least_seconds(one * 3, (540, 960), out, CARD) == pytest.approx(3 * t1)
    assert work.least_seconds(one, (540, 960), out, "some other card") is None
    nbytes, ops = work.frame_work(41600, *FRAME, (540, 960), out)
    assert nbytes >= 41600 * 13 and ops >= 41600 * 21


@pytest.mark.parametrize("output", list(PINNED))
def test_frame_work_pinned(output):
    """Each output's arithmetic, moved to outputs/<name>.py, counts what it
    counted before."""
    out = Spec().output(output)
    frame, wide, least = PINNED[output]
    assert work.frame_work(41600, *FRAME, (540, 960), out) == frame
    assert work.frame_work(253952, *WIDE, (540, 962), out) == wide
    assert work.least_seconds([("cama", 41600, [FRAME] * 47)] * 3, (540, 960), out,
                              CARD) == least


def test_evaluation_counts_its_fields():
    """The evaluation's fields make its frame cost more than reading the
    ground truth once."""
    nbytes, ops = work.frame_work(41600, *FRAME, (540, 960), Spec().output("gt_masks"))
    assert nbytes >= 6 * 540 * 960 * 6
    assert ops >= 6 * 540 * 960 * 18 + 4 * sum(FRAME[1])


def test_unknown_output_raises():
    with pytest.raises(ValueError, match="unknown device output"):
        Spec().output("no_such_output")
