"""The counts sidecar of the port (.cama_tpu/overlay_counts.json): a second
pipeline on a counted clip runs no counting pass and decides as the first
did, crop_compact_k never counts, scene_cache: false touches nothing, and
the port and the JAX package share the file without reading each other's
entries, as do two lanes of the port."""
import json
import os

import pytest

from cama_tpu import pipeline as jpipe
from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu_torch import pipeline as tp

COUNTING = ("count_union", "fused_compact_project", "crop_mask",
            "project_frames", "project_frame_pallas", "_encode_effective")


@pytest.fixture()
def clip(tmp_path):
    return make_fixture_clip(tmp_path, n_frames=4, with_images=False)


def _sidecar(clip):
    return os.path.join(clip, ".cama_tpu", "overlay_counts.json")


def _read(clip):
    with open(_sidecar(clip)) as f:
        return json.load(f)


def _count_calls(monkeypatch):
    """Spy on every function the counting pass can run: the list of names
    called since the last clear()."""
    calls = []
    for name in COUNTING:
        real = getattr(tp, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(tp, name, spy)
    monkeypatch.setitem(tp._LANE_PROJECTIONS, "pallas",
                        tp.project_frame_pallas)
    monkeypatch.setitem(tp._LANE_PROJECTIONS, "compact", tp.project_frames)
    return calls


def _decision(pipe, source):
    return (pipe.overlay_mode(source), pipe._fused_k[source],
            pipe._two_stage[source], pipe._k[source])


@pytest.mark.parametrize("lane", ["fused", "pallas", "compact", "scatter"])
def test_second_pipeline_skips_the_counting_pass(clip, monkeypatch, lane):
    calls = _count_calls(monkeypatch)
    first = tp.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane,
                            device="cpu")
    want = {s: _decision(first, s) for s in ("cama", "nuscenes")}
    assert calls, "the first pipeline must count"
    assert len(_read(clip)) == 2  # one entry per source
    calls.clear()
    second = tp.ClipPipeline(clip_path=clip, chunk=2, raster_kernel=lane,
                             device="cpu")
    assert {s: _decision(second, s) for s in want} == want
    assert calls == [], calls
    assert not second._dev, "a sidecar hit needs no tensors on the device"
    # and the lists it sizes hold: the stream runs and matches the first's
    a = dict(first.iter_overlay_rasters("cama"))
    b = dict(second.iter_overlay_rasters("cama"))
    assert a.keys() == b.keys() and all((a[i] == b[i]).all() for i in a)


def test_crop_compact_k_never_counts(tmp_path, monkeypatch):
    # labels spanning ~500 m while the crop keeps +-50 m: the split engages
    clip = make_fixture_clip(tmp_path, n_frames=4, with_images=False,
                             with_lidar=False, label_span=(-295.0, 200.0))
    calls = _count_calls(monkeypatch)
    pipe = tp.ClipPipeline(clip_path=clip, chunk=2, device="cpu")
    assert pipe.crop_compact_k("cama") is None  # fresh clip: not sized yet
    assert calls == [] and not os.path.exists(_sidecar(clip))
    pipe.overlay_mode("cama")
    k1 = pipe._two_stage["cama"]
    assert k1 is not None and k1 * 2 <= pipe.scene.flat["cama"].points.shape[0]
    assert pipe.crop_compact_k("cama") == k1
    calls.clear()
    later = tp.ClipPipeline(clip_path=clip, chunk=2, device="cpu")
    assert later.crop_compact_k("cama") == k1  # from the sidecar
    assert later.crop_compact_k("nuscenes") is None  # that source: unsized
    assert calls == []
    off = tp.ClipPipeline(clip_path=clip, chunk=2, device="cpu",
                          configs={"scene_cache": False})
    assert off.crop_compact_k("cama") is None and calls == []


def test_scene_cache_false_reads_and_writes_nothing(clip, monkeypatch):
    calls = _count_calls(monkeypatch)
    for _ in range(2):  # the second one counts again: nothing was kept
        calls.clear()
        pipe = tp.ClipPipeline(clip_path=clip, chunk=2, device="cpu",
                               configs={"scene_cache": False})
        pipe.overlay_mode("cama")
        assert calls
        assert not os.path.exists(os.path.join(clip, ".cama_tpu"))


def test_port_and_jax_package_share_the_file_not_the_entries(clip,
                                                             monkeypatch):
    calls = _count_calls(monkeypatch)
    jcalls = []
    real = jpipe._count_chunk
    monkeypatch.setattr(jpipe, "_count_chunk",
                        lambda *a, **k: jcalls.append(1) or real(*a, **k))
    # the JAX package first
    jp = jpipe.ClipPipeline(clip_path=clip, chunk=2, raster_kernel="compact")
    jmode = jp.overlay_mode("cama")
    jax_entries = _read(clip)
    assert jcalls and len(jax_entries) == 1
    # the port neither reads that entry (it counts) nor damages it
    pipe = tp.ClipPipeline(clip_path=clip, chunk=2, raster_kernel="compact",
                           device="cpu")
    mode = pipe.overlay_mode("cama")
    assert calls
    both = _read(clip)
    assert len(both) == 2
    assert all(both[k] == v for k, v in jax_entries.items())
    (port_key,) = set(both) - set(jax_entries)
    assert port_key == pipe._counts_sidecar_key("cama")
    assert port_key != jp._counts_sidecar_key("cama")
    assert mode == jmode  # same decision, each from its own counts
    # and the reverse: a fresh JAX pipeline serves from its own entry only
    jcalls.clear()
    jp2 = jpipe.ClipPipeline(clip_path=clip, chunk=2, raster_kernel="compact")
    assert jp2.overlay_mode("cama") == jmode and not jcalls
    jp2.overlay_mode("nuscenes")  # not stored yet: counts, then adds
    after = _read(clip)
    assert jcalls and len(after) == 3 and after[port_key] == both[port_key]


def test_two_lanes_keep_separate_entries(clip, monkeypatch):
    calls = _count_calls(monkeypatch)
    fused = tp.ClipPipeline(clip_path=clip, chunk=2, raster_kernel="fused",
                            device="cpu")
    fused.overlay_mode("cama")
    calls.clear()
    scatter = tp.ClipPipeline(clip_path=clip, chunk=2,
                              raster_kernel="scatter", device="cpu")
    scatter.overlay_mode("cama")
    assert "project_frames" in calls, "'scatter' must not read 'fused' counts"
    assert "count_union" not in calls
    entries = _read(clip)
    assert set(entries) == {fused._counts_sidecar_key("cama"),
                            scatter._counts_sidecar_key("cama")}
    assert all(len(v) == 3 for v in entries.values())


def test_damaged_or_foreign_sidecar_is_ignored_and_bounded(clip, monkeypatch):
    calls = _count_calls(monkeypatch)
    os.makedirs(os.path.dirname(_sidecar(clip)))
    with open(_sidecar(clip), "w") as f:
        f.write("{not json")
    pipe = tp.ClipPipeline(clip_path=clip, chunk=2, device="cpu")
    pipe.overlay_mode("cama")
    assert calls and list(_read(clip)) == [pipe._counts_sidecar_key("cama")]
    # an entry of another shape under this key is not trusted
    key = pipe._counts_sidecar_key("cama")
    with open(_sidecar(clip), "w") as f:
        json.dump({**{f"other{i}": [1, 2, 3] for i in range(40)},
                   key: [7, 7]}, f)
    calls.clear()
    again = tp.ClipPipeline(clip_path=clip, chunk=2, device="cpu")
    assert again.overlay_mode("cama") == pipe.overlay_mode("cama")
    assert calls
    kept = _read(clip)
    assert len(kept) == 32 and len(kept[key]) == 3  # the 32 most recent
