"""The least time the card could take for a window's work: the yardstick of
the device_roofline metrics.

Per served frame of a label source, the work the algorithm needs, counted
from the cell's shapes and the reference's own counts (render.counts), as
chip_smoke.py counts a kernel's bound: every input read once (the points'
coordinates, validity and class ids, 13 bytes a point; a frame's world to
chassis matrix and its camera matrices), the crop test of every
point-frame (three rows of 4 multiplies and 3 adds), and for each point
the crop keeps, each camera's three rows and two divides (23 operations);
plus the output written once:

  lists           each camera's kept points after dropping a point whose
                  successor lands on the same pixel, 4 bytes each, and a
                  4-byte count per camera
  packed_rasters  each camera's class raster at 2 bits a pixel
  gt_masks        the map evaluation of every camera at the output size
                  (h x w pixels): the ground-truth ids read (2 bytes a
                  pixel); the distance field to the mask, capped at the
                  evaluator's radius, by the two raster scans of the
                  chessboard distance (Rosenfeld and Pfaltz: per pixel and
                  scan 4 neighbours compared and 1 add, 10 operations),
                  written and read once at 1 byte a pixel; the kept points'
                  raster written and read once at 1 byte a pixel, and
                  dilated by the tolerance for recall, a separable running
                  maximum (van Herk: 3 operations a pixel and axis, 6);
                  the mask's and the covered pixels' sums (2 operations a
                  pixel); per kept point its field value taken, capped,
                  tested against the tolerance and summed (4 operations);
                  five sums written.  evaluate_scene builds no instance
                  vote field, so none is counted.

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


def frame_work(points, n_crop, kept, eff, size, output):
    """(bytes, operations) of one served frame: `points` the source's
    points, `n_crop` those in the crop, `kept` and `eff` per camera the
    points kept and those left after dropping same-pixel successors."""
    cameras = len(kept)
    h, w = size
    nbytes = points * 13 + 1 + 64 + cameras * 48
    ops = points * 21 + n_crop * 23 * cameras
    if output == "lists":
        nbytes += 4 * sum(eff) + 4 * cameras
    elif output == "packed_rasters":
        nbytes += cameras * h * -(-w // 4)
    elif output == "gt_masks":
        pixels = cameras * h * w
        nbytes += pixels * (2 + 2 + 2) + 5 * 4
        ops += pixels * (10 + 6 + 2) + 4 * sum(kept)
    else:
        raise ValueError(f"unknown device output {output!r}")
    return nbytes, ops


def least_seconds(window_work, size, output, device_name):
    """Least card seconds of the window's work `window_work`: [(source,
    points, [(n_crop, kept, eff)] per frame)], an entry per source and
    pass."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    total = 0.0
    for _src, points, frames in window_work:
        for n_crop, kept, eff in frames:
            nbytes, ops = frame_work(points, n_crop, kept, eff, size, output)
            total += max(nbytes / peak["bytes_per_s"], ops / peak["f32_ops_per_s"])
    return total
