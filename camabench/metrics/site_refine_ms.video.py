"""Milliseconds a video frame of the site's joint Sim(3) refinement
(`Site.refine_alignment`: the candidate pairs, the Adam steps and the
fetch of the final loss; phase site_refine)."""
LAYER = "site"
UNIT, SOURCE, MOVES = "ms/frame", "program_span", "video_fps"


def read(r):
    if r.produces != "video_frames" or "site_refine" not in r.timers or not r.frames:
        return None
    return 1e3 * r.timers["site_refine"] / r.frames
