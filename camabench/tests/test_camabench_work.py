"""The yardstick: the least time of a window's work for each kind of
device output, from a cell's shapes."""
from __future__ import annotations

import pytest

from camabench import work

CARD = "NVIDIA H100 80GB HBM3"
FRAME = (33428, [1267, 23798, 646, 864, 369, 0], [835, 3041, 351, 718, 201, 0])


@pytest.mark.parametrize("output", ["lists", "packed_rasters", "gt_masks"])
def test_least_seconds(output):
    one = [("cama", 41600, [FRAME] * 47)]
    t1 = work.least_seconds(one, (540, 960), output, CARD)
    assert t1 > 0
    assert work.least_seconds(one * 3, (540, 960), output, CARD) == pytest.approx(3 * t1)
    assert work.least_seconds(one, (540, 960), output, "some other card") is None
    nbytes, ops = work.frame_work(41600, *FRAME, (540, 960), output)
    assert nbytes >= 41600 * 13 and ops >= 41600 * 21


def test_evaluation_counts_its_fields():
    """The evaluation's fields make its frame cost more than reading the
    ground truth once."""
    nbytes, ops = work.frame_work(41600, *FRAME, (540, 960), "gt_masks")
    assert nbytes >= 6 * 540 * 960 * 6
    assert ops >= 6 * 540 * 960 * 18 + 4 * sum(FRAME[1])
