"""The generator: the same seed gives the same clip, another seed other
content with the same amount of work."""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from camabench import fixture
from camabench.reference import scene as ref_scene
from camabench.spec import Spec


def _digest(clip):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(clip)):
        for name in sorted(files):
            h.update(name.encode())
            with open(os.path.join(d, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _clip(tmp_path, tag, seed, gt=False):
    cfg = Spec().config("wide_span" if gt else "nusc_scene")
    cfg["frames_per_scene"] = 3
    clip = fixture.write_clip(str(tmp_path / tag), cfg, seed, 0)
    if gt:
        fixture.write_gt_masks(clip, cfg, seed, {"shift_px": [4.0, 6.0], "drop_instances": 1})
    return cfg, clip


def test_same_seed_same_fixture(tmp_path):
    seed = 2 ** 31 + 12345
    assert _digest(_clip(tmp_path, "a", seed)[1]) == _digest(_clip(tmp_path, "b", seed)[1])
    assert _digest(_clip(tmp_path, "c", seed, True)[1]) == _digest(_clip(tmp_path, "d", seed, True)[1])


def test_other_seed_same_work(tmp_path):
    cfg, a = _clip(tmp_path, "a", 1)
    _, b = _clip(tmp_path, "b", 2)
    assert _digest(a) != _digest(b)
    ra = ref_scene.load_clip(a, cfg["cameras"], (540, 960), ("cama", "nuscenes"))
    rb = ref_scene.load_clip(b, cfg["cameras"], (540, 960), ("cama", "nuscenes"))
    for src in ("cama", "nuscenes"):
        assert ra.points[src].shape == rb.points[src].shape
        assert len(ref_scene.served_frames(ra, src)) == len(ref_scene.served_frames(rb, src)) == 2


def test_label_fix_draws_move_labels_and_keep_counts(tmp_path):
    """Each label fix draws every polyline anew from the seed: other
    points, the same number of them, and the same draw for the same seed."""
    cfg, clip = _clip(tmp_path, "a", 31)
    grid = np.load(os.path.join(clip, "maps", "vision_road_mlp_ft.npy"))

    def lifted(draw):
        recs = fixture.label_records(cfg, 31, 0, draw)
        return (ref_scene.lift_cama(recs["map_labels.json"], grid, cfg["map_size_m"])[0],
                ref_scene.lift_nuscenes(recs["map_nuscenes.json"])[0])

    with open(os.path.join(clip, "maps", "map_labels.json")) as f:
        assert json.load(f) == fixture.label_records(cfg, 31, 0)["map_labels.json"]
    base, one, two = lifted(0), lifted(1), lifted(2)
    for a, b, c in zip(base, one, two):
        assert a.shape == b.shape == c.shape
        assert not np.allclose(a, b) and not np.allclose(b, c)
    assert all(np.array_equal(a, b) for a, b in zip(one, lifted(1)))
