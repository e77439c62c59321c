"""Milliseconds a video frame of the site's merge outside the refinement:
each member's Umeyama alignment and instance transform (site_align) and
the dedupe's candidate pairs, chamfer distances and keep scan
(site_dedupe)."""
LAYER = "site"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"
PHASES = ("site_align", "site_dedupe")


def read(r):
    if r.produces != "video_frames" or not any(p in r.timers for p in PHASES) or not r.frames:
        return None
    return 1e3 * sum(r.timers.get(p, 0.0) for p in PHASES) / r.frames
