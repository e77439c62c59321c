"""The least time the card could take for a window's work: the yardstick of
the device_roofline metrics.

Per served frame of a label source, the work the algorithm needs, counted
from the cell's shapes and the reference's own counts (render.counts), as
chip_smoke.py counts a kernel's bound: every input read once (the points'
coordinates, validity and class ids, 13 bytes a point; a frame's world to
chassis matrix and its camera matrices), the crop test of every
point-frame (three rows of 4 multiplies and 3 adds), and for each point
the crop keeps, each camera's three rows and two divides (23 operations);
plus what the cell's device output adds: the output written once and any
work on it, counted by outputs/<device_output>.py (found by Spec.output)
from the frame's counts and any further fields a loop's work() appends to
a frame's record for its output alone.

The least time is the larger of the bytes over the card's memory bandwidth
and the operations over its float32 rate (NVIDIA's data sheet at the card's
full power), summed over frames.
"""
from __future__ import annotations

# published peaks by torch.cuda.get_device_name(): HBM bytes/s, float32
# operations/s outside the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}


def frame_work(points, n_crop, kept, eff, size, output, *extra):
    """(bytes, operations) of one served frame: `points` the source's
    points, `n_crop` those in the crop, `kept` and `eff` per camera the
    points kept and those left after dropping same-pixel successors,
    `output` the device output's module (Spec.output), `extra` the frame
    record's further fields, for the output."""
    cameras = len(kept)
    nbytes = points * 13 + 1 + 64 + cameras * 48
    ops = points * 21 + n_crop * 23 * cameras
    out_bytes, out_ops = output.work(kept, eff, size, *extra)
    return nbytes + out_bytes, ops + out_ops


def least_seconds(window_work, size, output, device_name):
    """Least card seconds of the window's work `window_work`: [(source,
    points, [(n_crop, kept, eff, *extra)] per frame)], an entry per source
    and pass; `output` the device output's module (Spec.output)."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    total = 0.0
    for _src, points, frames in window_work:
        for n_crop, kept, eff, *extra in frames:
            nbytes, ops = frame_work(points, n_crop, kept, eff, size, output, *extra)
            total += max(nbytes / peak["bytes_per_s"], ops / peak["f32_ops_per_s"])
    return total
