"""A seeded pseudo-site at the size users run the site path: one shared road
network seen by several heavily overlapping clips, each in its own slightly
misaligned frame.

nuScenes scenes are about 20 s long and overlap heavily within one
location, and a CAMAv2 site merges the scenes that intersect.  Here every
clip sees a window of the network (lane markings and road edges along
rows, stop lines across them), each element sampled anew per clip (4-400
points, 2-5 cm noise), and every clip but clip 0 is moved by a known rigid
perturbation about its window's centre (1-1.5 deg of yaw, 0.5-0.8 m).
Same-class elements are at least 6 m apart, more than the refinement's
2 m pair tolerance plus what the perturbations move them, so every
candidate pair is one element seen by two clips: with neighbours among
them, the chamfer objective would pull the free clips together (a scale
below 1).  The default sizes give 16 clips of 112-122 elements (1,885 in
all), 8,567 candidate pairs at tol 2.0 and 5,015 at the dedupe's 0.5.
"""
from __future__ import annotations

import numpy as np

CLASSES = ("lane_marking", "Road_teeth", "Crosswalk_Line")
ROW = 10.0  # metres between the rows of the network


def road_network(rng, n_rows, length):
    """[(class, start [2], end [2])] element segments of the network."""
    out = []
    for r in range(n_rows):
        for cls, dy in (("lane_marking", 0.0), ("Road_teeth", 5.0)):
            x = rng.uniform(0.0, 5.0)
            while x < length:
                seg = rng.uniform(15.0, 30.0)
                y = ROW * r + dy + rng.uniform(-0.2, 0.2)
                out.append((cls, np.array([x, y]),
                            np.array([min(x + seg, length), y + rng.uniform(-0.5, 0.5)])))
                x += seg + rng.uniform(6.0, 10.0)
    # stop lines every 30 m, one across each row's lane (3.6 m long, 6.4 m
    # short of the next row's): they fix the position along the rows
    for x in np.arange(10.0, length, 30.0):
        for r in range(n_rows):
            xs = x + rng.uniform(-0.5, 0.5)
            out.append(("Crosswalk_Line", np.array([xs, ROW * r + 0.7]),
                        np.array([xs, ROW * r + 4.3])))
    return out


def _sample(rng, start, end):
    """4-400 points along a segment with a gentle bow, 2-5 cm noise: 10-100 %
    of the 0.1 m densification the lifted CAMA labels carry."""
    d = end - start
    n = int(np.clip(round(np.linalg.norm(d) / 0.1 * rng.uniform(0.1, 1.0)), 4, 400))
    t = np.linspace(0.0, 1.0, n)[:, None]
    normal = np.array([-d[1], d[0]]) / max(np.linalg.norm(d), 1e-9)
    xy = start + t * d + 0.3 * np.sin(np.pi * t) * normal
    pts = np.concatenate([xy, np.zeros((n, 1))], axis=1)
    return pts + rng.normal(0.0, rng.choice([0.02, 0.05]), pts.shape)


def _yaw(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), -np.sin(a), 0.0],
                     [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])


def make_site_case(n_clips=16, n_rows=8, window=150.0, overlap=16, seed=0):
    """dict of
    instances: [(class, points [n, 3] float64, clip)] as the clips see them
               (perturbed), clip-major
    truth:     the same instances before the perturbation
    perturb:   per clip (R [3, 3], t [3], center [3]): p' = R (p - center)
               + center + t; identity for clip 0
    """
    rng = np.random.default_rng(seed)
    step = window / overlap  # every element is seen by up to `overlap` clips
    length = window + step * (n_clips - 1)
    elements = road_network(rng, n_rows, length)
    y_mid = 0.5 * ROW * (n_rows - 1)
    instances, truth, perturb = [], [], []
    for c in range(n_clips):
        x0 = c * step
        center = np.array([x0 + window / 2.0, y_mid, 0.0])
        if c == 0:
            R, t = np.eye(3), np.zeros(3)
        else:
            R = _yaw(rng.choice([-1.0, 1.0]) * rng.uniform(1.0, 1.5))
            phi = rng.uniform(0.0, 2.0 * np.pi)
            t = rng.uniform(0.5, 0.8) * np.array([np.cos(phi), np.sin(phi), 0.0])
        perturb.append((R, t, center))
        for cls, start, end in elements:
            if x0 <= 0.5 * (start[0] + end[0]) < x0 + window:
                pts = _sample(rng, start, end)
                truth.append((cls, pts, c))
                instances.append((cls, (pts - center) @ R.T + center + t, c))
    return {"instances": instances, "truth": truth, "perturb": perturb}


def recovery_errors(clips, perturb):
    """Per clip (rotation error in degrees, translation error in metres at
    the window centre) of a site's refined Sim(3)s (Site.clips entries
    (path, scene, (r, t, s)) that started as the identity) composed with
    the perturbation: 0 where the refinement undid it exactly."""
    out = []
    for (_, _, (r, t, s)), (Rp, tp, center) in zip(clips, perturb):
        Rres = np.asarray(r) @ Rp
        cos = np.clip(0.5 * (np.trace(Rres) - 1.0), -1.0, 1.0)
        moved = s * (np.asarray(r) @ (center + tp)) + t
        out.append((float(np.degrees(np.arccos(cos))),
                    float(np.linalg.norm(moved - center))))
    return out
