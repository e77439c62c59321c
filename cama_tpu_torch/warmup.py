"""Cold-start warmup of the PyTorch port for a config's scenes.

Counterpart of cama_tpu/warmup.py.  The port's cold costs are not XLA
compiles (PyTorch runs eagerly) but the nvcc build of the kernel library,
the g++ build of the host compositor, the counting pass that sizes each
source's lists (persisted in the clip's counts sidecar, so a later process
skips it), and the JPEG decode + undistort of every camera image
(persisted in the frame cache).  This pays them up front:

    python -m cama_tpu_torch.warmup --config config.yaml [--scene NAME]
        [--source cama|nuscenes] [--frames] [--device cuda|cpu]

and prints one JSON line: per scene the scene compile, the builds and each
source's counting pass, timed; with --frames the frame cache fill; and the
first-frame latency of the first warmed scene.  With a 'cuda' request and
no card it prints one JSON error line and returns 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def warmup_kernels(pipe, sources=None):
    """Build what the pipeline's device path needs and run each source's
    counting pass once (ClipPipeline.overlay_mode, which writes the counts
    sidecar).  Returns {"build_seconds", "native_compositor",
    "native_seconds", source: {mode, k, seconds}}; build_seconds is None on
    a CPU pipeline, which runs the plain versions and builds nothing."""
    from cama_tpu_torch import _build, native

    out = {}
    t0 = time.perf_counter()
    if pipe.device.type == "cuda":
        _build.load()
        out["build_seconds"] = round(time.perf_counter() - t0, 2)
    else:
        out["build_seconds"] = None
    t0 = time.perf_counter()
    out["native_compositor"] = native.available()
    out["native_seconds"] = round(time.perf_counter() - t0, 2)
    for source in (sources or pipe.scene.sources):
        if source not in pipe.scene.flat:  # the skip the CLI and report apply
            out[source] = {"skipped": "no labels for source"}
            continue
        t0 = time.perf_counter()
        mode, k = pipe.overlay_mode(source)
        out[source] = {"mode": mode, "k": k,
                       "seconds": round(time.perf_counter() - t0, 2)}
    return out


def warmup_frames(pipe, n_threads=6):
    """Pre-build the frame cache: decode + undistort every camera image of
    the clip into the persistent store, so a later write_videos /
    iter_frames / report pass reads the warm mmap instead of paying JPEG
    decode + remap inline.  Byte-exact warm start by construction: the
    store is filled by the very undistorted_image calls a cold pass would
    make.  Returns {"images_cached", "hit_rate", "seconds"}."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    scene = pipe.scene

    def one(job):
        camera, idx = job
        try:
            pipe.undistorted_image(camera, idx, copy=False)
            return 1
        except (FileNotFoundError, IndexError, KeyError):
            return 0  # image-less clip / skipped frame: nothing to cache

    jobs = [(camera, idx) for idx in range(len(scene.frame_times))
            for camera in scene.camera_list]
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        n = sum(pool.map(one, jobs))
    fc = pipe.frame_cache()
    if fc is not None:
        fc.flush()
    return {"images_cached": n,
            "hit_rate": round(fc.hit_rate(), 4) if fc is not None else None,
            "seconds": round(time.perf_counter() - t0, 2)}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Build the kernels and run the counting passes for a "
                    "config's scenes")
    parser.add_argument("-c", "--config", default="config.yaml")
    parser.add_argument("--scene", default=None,
                        help="scene to warm (default: every configured scene "
                             "with a converted clip)")
    parser.add_argument("--source", default=None, choices=["cama", "nuscenes"])
    parser.add_argument("--frames", action="store_true",
                        help="also pre-decode every camera image into the "
                             "persistent frame cache (byte-exact warm start: "
                             "the first video/report pass skips JPEG decode "
                             "+ undistort)")
    parser.add_argument("--device", default=None,
                        help="torch device: 'cuda' (default) or 'cpu'; "
                             "overrides cama_configs.device")
    args = parser.parse_args(argv)

    from cama_tpu_torch import native
    from cama_tpu_torch.config import load_config
    from cama_tpu_torch.pipeline import ClipPipeline, resolve_device

    configs, cfg_device = load_config(args.config)
    try:
        device = resolve_device(args.device or cfg_device or "cuda")
    except RuntimeError as e:  # no card for a 'cuda' request: fail loudly
        print(json.dumps({"error": f"{e} — nothing warmed"}))
        return 1
    names = [args.scene] if args.scene else configs["scene_names"]
    names = list(dict.fromkeys(names))  # a scene listed twice is warmed once
    sources = [args.source] if args.source else None
    report = {"scenes": {}, "device": str(device),
              "native_compositor": native.available()}
    first_pipe = None
    for name in names:
        clip = os.path.join(configs["converted_dataroot"], name)
        if not os.path.exists(os.path.join(clip, "attribute.json")):
            report["scenes"][name] = {"skipped": "clip not converted"}
            continue
        try:  # per-scene isolation, as the CLI's
            t0 = time.perf_counter()
            pipe = ClipPipeline(configs.get("cama_configs"), clip,
                                device=device)
            compile_s = time.perf_counter() - t0
            entry = {"scene_compile_seconds": round(compile_s, 2),
                     "scene_cache_hit": pipe.scene.from_cache,
                     "kernels": warmup_kernels(pipe, sources)}
            if args.frames:
                entry["frames"] = warmup_frames(pipe)
        except Exception as e:
            report["scenes"][name] = {"error": repr(e)}
            continue
        report["scenes"][name] = entry
        if first_pipe is None:
            usable = [s for s in (sources or pipe.scene.sources)
                      if s in pipe.scene.flat]
            if usable:
                first_pipe = (pipe, usable[0])

    if first_pipe is not None:
        try:
            pipe, source = first_pipe
            t0 = time.perf_counter()
            it = pipe.iter_frames(source)
            next(it, None)
            it.close()
            report["first_frame_latency_seconds"] = round(
                time.perf_counter() - t0, 2)
        except Exception as e:
            report["first_frame_error"] = repr(e)
    print(json.dumps(report))
    return 0


def main_entry(argv=None):
    """Console-script / python -m entry point."""
    raise SystemExit(main(argv))


if __name__ == "__main__":
    main_entry()
