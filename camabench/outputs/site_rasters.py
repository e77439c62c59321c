"""A site pass's dense rasters and its chamfer work.  Per served frame, the
class raster of each camera at the output size, 2 bits a pixel, written
once (as packed_rasters.py counts it; the members' own frames and their
site frames alike).  On the one record of a pass that carries the pass's
chamfer work, whatever implements it: per refinement step and candidate
pair, the squared distance of each of the S x S point pairs (3
subtractions, 3 multiplications, 2 additions) and the two minima's
compares, 10 operations a point pair (the backward pass adds O(S) a pair
and is not counted); the dedupe's pairs the same at its own subsample; and
each pair's two point sets (3 float32 coordinates) and weights (1 float32)
read once an evaluation."""


def work(kept, eff, size, refine_pairs=0, refine_s=0, steps=0, dedupe_pairs=0, dedupe_s=0):
    h, w = size
    evals = [(refine_pairs * steps, refine_s), (dedupe_pairs, dedupe_s)]
    ops = sum(n * s * s * 10 for n, s in evals)
    nbytes = sum(n * 2 * s * 16 for n, s in evals)
    return len(kept) * h * -(-w // 4) + nbytes, ops
