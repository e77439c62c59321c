"""The map evaluation of every camera at the output size (h x w pixels):
the ground-truth ids read (2 bytes a pixel); the distance field to the
mask, capped at the evaluator's radius, by the two raster scans of the
chessboard distance (Rosenfeld and Pfaltz: per pixel and scan 4
neighbours compared and 1 add, 10 operations), written and read once at 1
byte a pixel; the kept points' raster written and read once at 1 byte a
pixel, and dilated by the tolerance for recall, a separable running
maximum (van Herk: 3 operations a pixel and axis, 6); the mask's and the
covered pixels' sums (2 operations a pixel); per kept point its field
value taken, capped, tested against the tolerance and summed (4
operations); five sums written.  evaluate_scene builds no instance vote
field, so none is counted."""


def work(kept, eff, size):
    h, w = size
    pixels = len(kept) * h * w
    return pixels * (2 + 2 + 2) + 5 * 4, pixels * (10 + 6 + 2) + 4 * sum(kept)
