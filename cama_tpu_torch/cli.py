"""Command line of the PyTorch port, the same config surface as main.py: per
scene — convert nuScenes -> clip when needed, extract CAMA labels from the
release zip, and write the cama + nuScenes overlay videos.

    python -m cama_tpu_torch.cli --config config.yaml [--device cuda|cpu]

The device comes from --device, else cama_configs.device, else 'cuda'; the
device lane from cama_configs.raster_kernel, else 'auto' (which serves
'fused').  With two or more scenes and `batch_scenes` (default true),
scenes of one output size are written together through
MultiScenePipeline, as main.py does; otherwise one after another.  A scene
with no attribute.json yet is converted first by this package's
NuScenesConverter (convert/nuscenes.py; it needs the nuScenes devkit, like
main.py).  Not supported yet, and reported as a failure: the `sites:`
aggregation block.
"""
from __future__ import annotations

import argparse
import os
import time
import zipfile

from cama_tpu_torch.config import load_config
from cama_tpu_torch.io.scene import DEFAULT_CAMA_CONFIGS
from cama_tpu_torch.pipeline import ClipPipeline, MultiScenePipeline


def _extract_all_labels(zip_filepath, scene_names, dest_dir):
    """Extract every configured scene's label files in ONE pass over the
    release zip."""
    prefixes = tuple(f"{name}/" for name in scene_names)
    with zipfile.ZipFile(zip_filepath, "r") as zf:
        for member in zf.namelist():
            if member.startswith(prefixes):
                zf.extract(member, dest_dir)
                if member.endswith("/"):
                    os.makedirs(os.path.join(dest_dir, member), exist_ok=True)


def _isolated(label, failures, fn, *args, **kwargs):
    """Run one scene in isolation: an exception prints its traceback and
    records (label, repr(e)) in `failures`; the batch keeps going and the
    exit code reports it."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        import traceback

        traceback.print_exc()
        failures.append((label, repr(e)))
        return None


def run(configs, device="cuda"):
    t_run0 = time.perf_counter()
    output_dir = configs["converted_dataroot"]
    os.makedirs(output_dir, exist_ok=True)
    output_video_dir = configs["output_video_dir"]
    os.makedirs(output_video_dir, exist_ok=True)
    # order-preserving dedupe: a scene listed twice is written once
    scene_names = list(dict.fromkeys(configs["scene_names"]))

    def first_frame_cb(label):
        def cb():
            print(f"[{label}] first video frame at "
                  f"{time.perf_counter() - t_run0:.1f}s", flush=True)
        return cb

    # CAMA label files into the clip dirs: one zip pass, only for scenes
    # whose labels are not already on disk
    zip_file = configs.get("cama_label_file")
    if zip_file:
        if os.path.exists(zip_file):
            cc = {**DEFAULT_CAMA_CONFIGS, **(configs.get("cama_configs") or {})}
            need = [n for n in scene_names if not os.path.exists(os.path.join(
                output_dir, n, cc["result_dir"], cc["cama_map_file"]))]
            if need:
                _extract_all_labels(zip_file, need, output_dir)
        else:
            print(f"warning: cama_label_file not found: {zip_file} — "
                  "scenes without already-extracted labels will skip their "
                  "cama video", flush=True)

    state = {"converter": None}  # built at the first unconverted scene
    failures = []
    to_write = []  # (scene_name, pipeline, {source: video_path})
    for scene_name in scene_names:
        item = _isolated(scene_name, failures, _prepare_scene, configs,
                         scene_name, output_dir, output_video_dir, device,
                         state)
        if item is not None and item[2]:
            to_write.append(item)
    if configs.get("batch_scenes", True) and len(to_write) > 1:
        failures += _write_batched(configs, to_write, first_frame_cb)
    else:
        for item in to_write:
            _isolated(item[0], failures, _write_scene_videos, configs, *item,
                      first_frame_cb(item[0]))
    if configs.get("sites"):
        failures.append(("sites", "site aggregation is not supported by "
                                  "cama_tpu_torch yet"))
    if failures:
        print(f"{len(failures)} scene(s) failed: {failures}")
    return failures


def _prepare_scene(configs, scene_name, output_dir, output_video_dir,
                   device, state):
    """Convert the scene when it is not a clip yet, then compile its
    pipeline.  `state` carries the one lazily built NuScenesConverter across
    scenes.  Returns (scene_name, pipeline, {source: video_path})."""
    clip_path = os.path.join(output_dir, scene_name)
    if not os.path.exists(os.path.join(clip_path, "attribute.json")):
        if state["converter"] is None:
            from cama_tpu_torch.convert.nuscenes import NuScenesConverter

            state["converter"] = NuScenesConverter(configs)
        state["converter"].convert(scene_name)
    kern = (configs.get("cama_configs") or {}).get("raster_kernel") or "auto"
    pipe = ClipPipeline(configs.get("cama_configs"), clip_path,
                        raster_kernel=kern, device=device)
    if pipe.scene.from_cache:
        print(f"[{scene_name}] scene cache hit — lifting skipped")
    paths = {}
    for source, suffix in (("cama", "cama"), ("nuscenes", "nuScenes")):
        if source not in pipe.scene.flat:
            print(f"[{scene_name}] no {source} labels; skipping video")
            continue
        paths[source] = os.path.join(output_video_dir, f"{scene_name}_{suffix}.mp4")
    return scene_name, pipe, paths


def _write_scene_videos(configs, scene_name, pipe, paths, on_first_frame=None):
    """One pass over the clip writes every source's video."""
    modes = ", ".join(f"{src} {pipe.serving_mode(src)[0]}" for src in paths)
    print(f"[{scene_name}] generating reprojection videos "
          f"({', '.join(paths)} labels) on {pipe.device}, raster_kernel "
          f"{pipe.raster_kernel!r}, serving {modes}...")
    t0 = time.perf_counter()
    counts = pipe.write_videos(paths, preset=configs.get("video_preset"),
                               on_first_frame=on_first_frame)
    dt = time.perf_counter() - t0
    for source, out in paths.items():
        print(f"  {counts[source]} frames -> {out}")
    total = sum(counts.values())
    print(f"  {total} video-frames in {dt:.1f}s ({total / max(dt, 1e-9):.1f} fps)")


def _write_batched(configs, items, first_frame_cb):
    """Scene-batched video writing: groups scenes by output size and writes
    each group of two or more through MultiScenePipeline (one raster stage
    per chunk for all of the group's scenes); a scene alone in its group
    is written by itself.  Returns failures."""
    failures = []
    groups = {}
    for item in items:
        groups.setdefault(item[1].scene.output_size, []).append(item)
    for size, group in groups.items():
        if len(group) == 1:
            _isolated(group[0][0], failures, _write_scene_videos, configs,
                      *group[0], first_frame_cb(group[0][0]))
            continue
        names = [g[0] for g in group]
        print(f"Batching {len(group)} scenes at {size[1]}x{size[0]} through "
              f"one device program per chunk: {', '.join(names)}")

        def write_group(group=group, names=names):
            msp = MultiScenePipeline([g[1] for g in group],
                                     chunk=group[0][1].chunk)
            t0 = time.perf_counter()
            counts = msp.write_videos(
                [g[2] for g in group], preset=configs.get("video_preset"),
                on_first_frame=first_frame_cb("+".join(names)))
            dt = time.perf_counter() - t0
            total = 0
            for (scene_name, _, paths), cnt in zip(group, counts):
                for source, out in paths.items():
                    print(f"  [{scene_name}] {cnt[source]} frames -> {out}")
                total += sum(cnt.values())
            print(f"  {total} video-frames in {dt:.1f}s "
                  f"({total / max(dt, 1e-9):.1f} fps, scene-batched)")

        _isolated(names, failures, write_group)
    return failures


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Write CAMA overlay videos with the PyTorch/CUDA port.")
    parser.add_argument(
        "-c", "--config", type=str, default="config.yaml",
        help="Path to the configuration file.",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device: 'cuda' (default) or 'cpu' (plain PyTorch "
             "versions of the kernels); overrides cama_configs.device.",
    )
    args = parser.parse_args(argv)
    configs, cfg_device = load_config(args.config)
    failures = run(configs, device=args.device or cfg_device or "cuda")
    return 1 if failures else 0


def main_entry(argv=None):
    """Console-script / python -m entrypoint."""
    raise SystemExit(main(argv))


if __name__ == "__main__":
    main_entry()
