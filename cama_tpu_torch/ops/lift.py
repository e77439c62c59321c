"""2-D label -> 3-D polyline lifting (host-side scene compilation).

A copy of cama_tpu/ops/lift.py, cut to what the port uses: the constants
(map extent, crop box, colors, class names), the CAMA and nuScenes lifting
with their helpers, and FlatPoints.  The point flattening is in
io/scene.py.  Bit-exact to the reference's float32 arithmetic: the same op
order, the same float32 intermediate types, the same
round()->uint16->clip->gather height sampling
(tests/test_torch_host.py holds it against the original).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SOLUTION = 0.1  # meter per BEV pixel AND densify step (cama/reproject.py:23)

# numpy 1.x promotes float32-scalar / python-float to float64; NEP 50 keeps
# float32 — densify_polyline matches the running regime (see its docstring)
_SCALAR_DIV_PROMOTES_F64 = (np.float32(1) / 0.1).dtype == np.float64
MAP_WIDTH = 600.0  # meters (cama/reproject.py:26-27; v1 labels use 300)
MAP_HEIGHT = 600.0
CENTER_X = 0.0
CENTER_Y = 0.0

# crop box in the chassis frame (cama/reproject.py:28-34)
CROP_BOX = {
    "x_min": -50.0, "x_max": 50.0,
    "y_min": -100.0, "y_max": 100.0,
    "z_min": -200.0, "z_max": 200.0,
}

# render colors, RGB (cama/reproject.py:11-17); drawn reversed (BGR) on
# BGR-ordered images like the reference
COLOR_MAPS = {
    "Road_teeth": np.array([235, 73, 127]),
    "lane_marking": np.array([211, 211, 211]),
    "Stop_Line": np.array([211, 211, 211]),
    "Crosswalk_Line": np.array([255, 215, 0]),
}

# quirky-but-load-bearing label names (SURVEY.md §2, config.yaml:14)
DEFAULT_CLASS_NAMES = ["lane_marking", "Road_teeth", "Crosswalk_Line", "Stop_Line"]


def densify_polyline(line_points, solution=SOLUTION):
    """Resample a polyline at `solution` steps, bit-exact to the reference's
    per-segment loop (cama/reproject.py:81-93):
        num = int(|seg| / solution);   p_j = start + (seg / num) * j

    Args:
        line_points: [M, 2] float32
    Returns:
        [T, 2] float32 (T = sum of per-segment counts; may be 0)
    """
    pts = np.asarray(line_points, dtype=np.float32)
    if len(pts) <= 1:
        return np.zeros((0, 2), dtype=np.float32)
    seg = pts[1:] - pts[:-1]
    length = np.linalg.norm(seg, axis=-1).astype(np.float32)
    # the reference divides a float32 SCALAR by a python float: float32 under
    # NEP 50 (numpy >= 2), float64 under numpy 1.x — mirror whichever regime
    # the running interpreter uses so the truncated count stays bit-exact
    if _SCALAR_DIV_PROMOTES_F64:
        num = (length.astype(np.float64) / solution).astype(np.int64)
    else:
        num = (length / np.float32(solution)).astype(np.int64)  # int() truncation
    total = int(num.sum())
    if total == 0:
        return np.zeros((0, 2), dtype=np.float32)
    seg_id = np.repeat(np.arange(len(seg)), num)
    offsets = np.concatenate([[0], np.cumsum(num)[:-1]])
    j = (np.arange(total) - np.repeat(offsets, num)).astype(np.float32)
    # float32 op order identical to the reference scalar loop
    step = seg[seg_id] / num[seg_id].astype(np.float32)[:, None]
    return pts[seg_id] + step * j[:, None]


def pixel2world_xy(pixel_xy, solution=SOLUTION, map_width=MAP_WIDTH,
                   map_height=MAP_HEIGHT, center_x=CENTER_X, center_y=CENTER_Y):
    """BEV pixel (x=col-ish, y=row-ish) -> world meters
    (cama/reproject.py:36-40): note the column swap — world x comes from the
    SECOND pixel column."""
    pixel_xy = np.asarray(pixel_xy)
    world = np.zeros_like(pixel_xy)
    world[:, 0] = pixel_xy[:, 1] * solution - map_width / 2 + center_x
    world[:, 1] = pixel_xy[:, 0] * solution - map_height / 2 + center_y
    return world


def sample_height(bev_height, dense_xy):
    """Nearest-pixel height gather, bit-exact to cama/reproject.py:96-99:
    round (half-to-even) -> uint16 (wraps negatives) -> axis swap -> clip to
    [0, H-1] on BOTH axes using shape[0] (square-grid assumption preserved)."""
    px = dense_xy.round().astype(np.uint16)
    px = px[:, ::-1]
    px = px.clip(0, bev_height.shape[0] - 1)
    return bev_height[px[:, 0], px[:, 1]]


def lift_cama_instances(labels, bev_height, solution=SOLUTION,
                        map_width=MAP_WIDTH, map_height=MAP_HEIGHT):
    """CAMA path (cama/reproject.py:72-106): label polylines are in BEV pixel
    coords; densify, sample per-point height from the BEV grid, convert
    pixels->meters.  Returns list of (class_name, points[P, 3]).

    map_width/map_height default to the v2 labels' 600 m; v1 labels use 300 m
    (reference README.md:29's manual edit becomes a parameter here)."""
    out = []
    for instance in labels:
        cls = instance["attrs"]["type"]
        pts = instance["data"]
        if len(pts) <= 1:  # too short, neglect (reference drops these)
            continue
        dense = densify_polyline(np.asarray(pts, dtype=np.float32), solution)
        if len(dense) == 0:
            # total polyline length < solution: the reference would crash on
            # the empty-array indexing that follows; we drop the instance
            continue
        h = sample_height(bev_height, dense)
        world_xy = pixel2world_xy(dense, solution, map_width, map_height)
        out.append((cls, np.concatenate([world_xy, h[:, None]], axis=-1).reshape(-1, 3)))
    return out


def lift_nuscenes_instances(labels, solution=SOLUTION):
    """nuScenes path (cama/reproject.py:42-70): polylines already in meters;
    densify at `solution`; height == 0."""
    out = []
    for instance in labels:
        cls = instance["attrs"]["type"]
        pts = instance["data"]
        if len(pts) <= 1:
            continue
        dense = densify_polyline(np.asarray(pts, dtype=np.float32), solution)
        if len(dense) == 0:
            continue
        h = np.zeros_like(dense[:, 0])
        out.append((cls, np.concatenate([dense, h[:, None]], axis=-1).reshape(-1, 3)))
    return out


@dataclass
class FlatPoints:
    """Instance-major flattened point set with validity padding."""

    points: np.ndarray  # [Npad, 3] float32 (world frame)
    cls: np.ndarray  # [Npad] int32, index into class_names
    inst: np.ndarray  # [Npad] int32
    valid: np.ndarray  # [Npad] bool
    class_names: list = field(default_factory=list)

    @property
    def num_valid(self):
        return int(self.valid.sum())
