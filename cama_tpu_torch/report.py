"""Scene QA report: one self-contained HTML page per config, on PyTorch.

Counterpart of cama_tpu/report.py.  Per scene it collates the evidence a
label release is checked by: overlay thumbnails (the visual check),
SRE/precision/recall/F1 map quality, instance association and KITTI-style
pose metrics; per `sites:` entry, the merged map's counts.  All of it goes
into one HTML file with no external assets, so QA of a label release is one
command:

    python -m cama_tpu_torch.report --config config.yaml [--out report.html]
        [--device cuda|cpu]

The device comes from --device, else cama_configs.device, else 'cuda'; a
'cuda' request without a card fails before any scene is read.  Scenes fail
independently (the CLI's isolation); a scene whose GT masks or pose files
are absent reports what it can and says what is missing.  The last line of
standard output is one JSON object: the report's path and the counts of
scenes, sites and failures.
"""
from __future__ import annotations

import base64
import html
import json
import os
import time


def _thumbnail_b64(pipe, source, image_idx, width=720):
    """One overlay mosaic as a base64 JPEG (downscaled for the report)."""
    import cv2

    from cama_tpu_torch.io.video import concat_camera_grid

    raster = pipe._overlay_single(source, image_idx)
    images = pipe.composite_frame(source, image_idx, raster)
    mosaic = concat_camera_grid(images)
    h = max(1, round(mosaic.shape[0] * width / mosaic.shape[1]))
    small = cv2.resize(mosaic, (width, h), interpolation=cv2.INTER_AREA)
    ok, buf = cv2.imencode(".jpg", small, [cv2.IMWRITE_JPEG_QUALITY, 82])
    if not ok:
        return None
    return base64.b64encode(buf.tobytes()).decode("ascii")


def _pose_metrics(clip_path, configs):
    """KITTI-style metrics of the clip's SfM chain vs its ego odometry, or
    None when either trajectory file is absent."""
    import numpy as np

    from cama_tpu_torch.eval.pose_metrics import PoseEvaluator

    prefix = (configs or {}).get("pose_prefix", "scmv")
    camera = (configs or {}).get("camera_main", "camera_front")
    pred_path = os.path.join(clip_path, "odometry", f"{prefix}_{camera}.txt")
    gt_path = os.path.join(clip_path, "odometry", "wigo.txt")
    if not (os.path.exists(pred_path) and os.path.exists(gt_path)):
        return None
    res = PoseEvaluator(alignment="7dof", min_matches=5).eval(
        np.loadtxt(gt_path), np.loadtxt(pred_path))
    return {k: float(v) for k, v in res.items()
            if np.isscalar(v) or getattr(v, "ndim", 1) == 0}


def scene_summary(pipe, sources=None, thumbnails=3, tolerance=5,
                  instances=True, max_frames=None, precomputed=None,
                  eval_backend="device"):
    """All QA evidence for one compiled scene, as a plain dict.
    max_frames: evaluate/thumbnail only the first N valid frames (quick-look
    reports on long clips).
    precomputed: optional {source: metric dict} from a fleet-batched
    evaluation (evaluate_scene_batch), used instead of re-evaluating."""
    import numpy as np

    from cama_tpu_torch.eval.map_metrics import MapEvaluator

    scene = pipe.scene
    requested = list(sources or sorted(scene.flat))
    sources = [s for s in requested if s in scene.flat]
    out = {
        "scene": os.path.basename(os.path.normpath(scene.clip_path)),
        "clip_path": scene.clip_path,
        "sources": {},
        "scene_cache_hit": bool(scene.from_cache),
        "output_size": list(scene.output_size),
    }
    missing = [s for s in requested if s not in scene.flat]
    if missing:  # a requested source the scene never lifted is a finding
        out["missing_sources"] = missing
    for source in sources:
        fm = pipe.frame_matrices(source)
        n_valid = int(np.asarray(fm.frame_valid).sum())
        valid_idxs = [int(i) for i in np.asarray(fm.frame_indices)[
            np.asarray(fm.frame_valid)]]
        frames = (set(valid_idxs[:max_frames]) if max_frames is not None
                  else None)
        entry = {"frames": n_valid,
                 "points": int(scene.flat[source].valid.sum()),
                 "instances": int(len(np.unique(
                     scene.flat[source].inst[scene.flat[source].valid])))}
        ev = MapEvaluator(tolerance=tolerance, backend=eval_backend)
        try:
            if precomputed and source in precomputed:
                metrics = precomputed[source]
            else:
                metrics = (ev.evaluate_scene_all(pipe, source, frames=frames)
                           if instances
                           else ev.evaluate_scene(pipe, source, frames=frames))
            if metrics.get("frames_evaluated"):
                entry["map_metrics"] = metrics
            else:
                entry["map_metrics_note"] = "no GT instance masks in clip"
        except Exception as e:  # map metrics are optional evidence
            entry["map_metrics_note"] = f"unavailable: {e!r}"
        # thumbnails spread across the scene, first available source only
        if thumbnails and not out.get("thumbs"):
            idxs = (valid_idxs[:max_frames] if max_frames is not None
                    else valid_idxs)
            # spread over n_picks: with fewer frames than requested,
            # dividing by thumbnails - 1 would collapse the picks
            n_picks = min(thumbnails, len(idxs))
            picks = sorted({idxs[int(k * (len(idxs) - 1) / max(n_picks - 1, 1))]
                            for k in range(n_picks)})
            thumbs = []
            for idx in picks:
                try:
                    b64 = _thumbnail_b64(pipe, source, idx)
                except FileNotFoundError:
                    # metrics-only clip (no camera JPEGs): numbers only
                    thumbs = []
                    break
                if b64:
                    thumbs.append({"source": source, "image_idx": idx,
                                   "jpeg_b64": b64})
            out["thumbs"] = thumbs
        out["sources"][source] = entry
    try:
        pose = _pose_metrics(scene.clip_path, pipe.configs)
        if pose is not None:
            out["pose_metrics"] = pose
    except Exception as e:  # optional evidence: a trajectory that fails
        # timestamp association must not fail the whole scene's report
        out["pose_metrics_note"] = f"unavailable: {e!r}"
    return out


def site_summary(configs, pipes_by_name, entry, device=None):
    """QA evidence for one `sites:` config entry: member count, merged-map
    element counts per class, duplicates removed by cross-clip dedupe, and
    the joint-refinement chamfer residual when the entry asks for it, on
    `device` (default: Site's).  Mirrors Site.from_clips step by step so
    the intermediate numbers land in the report."""
    from cama_tpu_torch.aggregate.site import Site

    name, members, refine = entry["name"], entry["scenes"], entry["refine"]
    out = {"site": name, "members": members, "refined": bool(refine)}
    missing = [m for m in members
               if m not in pipes_by_name
               or "cama" not in pipes_by_name[m].scene.flat]
    if missing:
        out["note"] = f"members unavailable (not converted / no cama labels): {missing}"
        return out
    # the same config hand-off as Site.from_clips, so the two builds agree
    site = Site(name=name, configs=(configs or {}).get("cama_configs"),
                device=device)
    for m in members:
        pipe = pipes_by_name[m]
        site.add_clip(pipe.scene.clip_path, pipe.scene)
    out["instances_raw"] = len(site.instances)
    if refine:
        before, after = site.refine_alignment()
        out["refine_chamfer_before_m"] = round(float(before), 4)
        out["refine_chamfer_after_m"] = round(float(after), 4)
    out["duplicates_removed"] = site.dedupe()
    out["instances_merged"] = len(site.instances)
    classes = {}
    for cls_name, _pts, _ci in site.instances:
        classes[cls_name] = classes.get(cls_name, 0) + 1
    out["classes"] = classes
    return out


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return html.escape(str(v))


def _metrics_table(d):
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td><td>{_fmt(v)}</td></tr>"
        for k, v in d.items() if not isinstance(v, (dict, list)))
    return f"<table>{rows}</table>"


def render_html(summaries, title="cama_tpu QA report", sites=None):
    """Self-contained HTML (inline CSS, base64 images, no external assets);
    the JAX package's page, byte for byte."""
    css = ("body{font-family:sans-serif;margin:2em;max-width:1000px}"
           "table{border-collapse:collapse;margin:0.5em 0}"
           "td,th{border:1px solid #ccc;padding:2px 8px;font-size:13px}"
           "h2{border-bottom:2px solid #444;padding-bottom:2px}"
           "img{display:block;margin:6px 0;max-width:100%}"
           ".note{color:#a40;font-size:13px}"
           ".meta{color:#666;font-size:12px}")
    parts = [f"<!doctype html><html><head><meta charset='utf-8'>"
             f"<title>{html.escape(title)}</title><style>{css}</style></head>"
             f"<body><h1>{html.escape(title)}</h1>"
             f"<p class='meta'>generated {time.strftime('%Y-%m-%d %H:%M:%S')}"
             f" — {len(summaries)} scene(s)</p>"]
    for s in summaries:
        if "error" in s:
            parts.append(f"<h2>{html.escape(s['scene'])}</h2>"
                         f"<p class='note'>FAILED: {html.escape(s['error'])}</p>")
            continue
        parts.append(f"<h2>{html.escape(s['scene'])}</h2>")
        parts.append(f"<p class='meta'>{html.escape(s['clip_path'])} — "
                     f"scene cache {'hit' if s['scene_cache_hit'] else 'miss'}"
                     f", output {s['output_size'][1]}x{s['output_size'][0]}</p>")
        if s.get("missing_sources"):
            parts.append(
                f"<p class='note'>requested source(s) not lifted in this "
                f"scene: {html.escape(', '.join(s['missing_sources']))}</p>")
        for source, entry in s["sources"].items():
            parts.append(f"<h3>{html.escape(source)} labels</h3>")
            head = {k: entry[k] for k in ("frames", "points", "instances")}
            parts.append(_metrics_table(head))
            if "map_metrics" in entry:
                parts.append("<h4>map quality</h4>")
                parts.append(_metrics_table(entry["map_metrics"]))
            elif "map_metrics_note" in entry:
                parts.append(f"<p class='note'>map metrics: "
                             f"{html.escape(entry['map_metrics_note'])}</p>")
        if s.get("pose_metrics"):
            parts.append("<h4>pose metrics (SfM chain vs ego odometry, "
                         "7dof-aligned)</h4>")
            parts.append(_metrics_table(s["pose_metrics"]))
        elif s.get("pose_metrics_note"):
            parts.append(f"<p class='note'>pose metrics: "
                         f"{html.escape(s['pose_metrics_note'])}</p>")
        for t in s.get("thumbs", ()):
            parts.append(
                f"<p class='meta'>{html.escape(t['source'])} overlay, frame "
                f"{t['image_idx']}</p>"
                f"<img src='data:image/jpeg;base64,{t['jpeg_b64']}'/>")
    for s in sites or ():
        parts.append(f"<h2>site: {html.escape(s['site'])}</h2>")
        parts.append(f"<p class='meta'>members: "
                     f"{html.escape(', '.join(s['members']))}</p>")
        if s.get("error"):
            parts.append(f"<p class='note'>FAILED: {html.escape(s['error'])}</p>")
            continue
        if s.get("note"):
            parts.append(f"<p class='note'>{html.escape(s['note'])}</p>")
            continue
        head = {k: v for k, v in s.items()
                if k not in ("site", "members", "classes")}
        parts.append(_metrics_table(head))
        parts.append("<h4>merged map elements per class</h4>")
        parts.append(_metrics_table(s.get("classes", {})))
    parts.append("</body></html>")
    return "".join(parts)


def _batch_metrics(pipes, args):
    """Fleet-batched map metrics for report scenes sharing an output size:
    one wave of device work per chunk for the whole group
    (MapEvaluator.evaluate_scene_batch) instead of per-scene evaluation.
    Quick-look runs (--max-frames) and the host backend evaluate per scene
    instead.  A failure falls back silently to per-scene evaluation.
    Returns {scene_name: {source: metric dict}}."""
    if args.max_frames is not None:
        return {}
    if getattr(args, "eval_backend", "device") == "host":
        return {}  # the host backend evaluates per scene
    real = [(n, p) for n, p in pipes.items() if not isinstance(p, dict)]
    groups = {}
    for n, p in real:
        groups.setdefault(tuple(p.scene.output_size), []).append((n, p))
    from cama_tpu_torch.eval.map_metrics import MapEvaluator

    out = {}
    ev = MapEvaluator(tolerance=args.tolerance)
    for group in groups.values():
        if len(group) < 2:
            continue
        names = [n for n, _ in group]
        members = [p for _, p in group]
        sources = ([args.source] if args.source
                   else sorted({s for p in members for s in p.scene.flat}))
        for source in sources:
            try:
                res = ev.evaluate_scene_batch(
                    members, source, instances=not args.no_instances)
            except Exception:  # the batch path is an optimization, never fatal
                continue
            for name, r in zip(names, res):
                if r is not None and r.get("frames_evaluated"):
                    out.setdefault(name, {})[source] = r
    return out


def main(argv=None):
    import argparse
    import traceback

    from cama_tpu_torch.config import load_config, normalize_site_entry
    from cama_tpu_torch.pipeline import ClipPipeline, resolve_device

    parser = argparse.ArgumentParser(
        description="Collate overlay thumbnails + map/pose metrics into one "
                    "self-contained HTML QA report")
    parser.add_argument("-c", "--config", default="config.yaml")
    parser.add_argument("-o", "--out", default=None,
                        help="output HTML path (default: "
                             "{output_video_dir}/report.html)")
    parser.add_argument("--source", default=None,
                        choices=["cama", "nuscenes"],
                        help="restrict to one label source")
    parser.add_argument("--thumbnails", type=int, default=3)
    parser.add_argument("--tolerance", type=int, default=5)
    parser.add_argument("--no-instances", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None,
                        help="quick-look: evaluate only the first N frames")
    parser.add_argument("--eval-backend", default="device",
                        choices=["device", "host"],
                        help="'host' evaluates with NumPy/SciPy, with no "
                             "tensor work")
    parser.add_argument("--device", default=None,
                        help="torch device: 'cuda' (default) or 'cpu'; "
                             "overrides cama_configs.device")
    args = parser.parse_args(argv)
    if args.max_frames is not None and args.max_frames < 1:
        parser.error("--max-frames must be >= 1")

    configs, cfg_device = load_config(args.config)
    device = resolve_device(args.device or cfg_device or "cuda")
    out_path = args.out or os.path.join(configs["output_video_dir"],
                                        "report.html")
    summaries = []
    failures = 0
    # a LIST, not a dict: a scene listed twice in scene_names gets two
    # report sections (matching the config), sharing one pipeline
    pipe_list = []  # (scene_name, ClipPipeline | {"error": ...})
    by_name = {}
    for scene_name in configs["scene_names"]:
        if scene_name in by_name:
            pipe_list.append((scene_name, by_name[scene_name]))
            continue
        clip = os.path.join(configs["converted_dataroot"], scene_name)
        if not os.path.exists(os.path.join(clip, "attribute.json")):
            item = {"error": "clip not converted"}
        else:
            try:
                kern = (configs.get("cama_configs") or {}).get(
                    "raster_kernel") or "auto"
                item = ClipPipeline(configs.get("cama_configs"), clip,
                                    raster_kernel=kern, device=device)
            except Exception as e:
                traceback.print_exc()
                item = {"error": repr(e)}
        by_name[scene_name] = item
        pipe_list.append((scene_name, item))
    pipes = by_name

    precomputed = _batch_metrics(pipes, args)

    summarized = {}  # scene_name -> summary: duplicates share the work
    for scene_name, pipe in pipe_list:
        if isinstance(pipe, dict):
            summaries.append({"scene": scene_name, **pipe})
            failures += 1
            continue
        if scene_name in summarized:
            summaries.append(summarized[scene_name])
            continue
        try:
            summary = scene_summary(
                pipe, sources=[args.source] if args.source else None,
                thumbnails=args.thumbnails, tolerance=args.tolerance,
                instances=not args.no_instances,
                max_frames=args.max_frames,
                precomputed=precomputed.get(scene_name),
                eval_backend=args.eval_backend)
            summarized[scene_name] = summary
            summaries.append(summary)
        except Exception as e:
            traceback.print_exc()
            summaries.append({"scene": scene_name, "error": repr(e)})
            failures += 1
    site_summaries = []
    if configs.get("sites"):
        real = {n: p for n, p in pipes.items() if not isinstance(p, dict)}
        for i, site_cfg in enumerate(configs["sites"]):
            entry = normalize_site_entry(site_cfg, i, len(configs["sites"]))
            try:
                site_summaries.append(site_summary(configs, real, entry,
                                                   device=device))
            except Exception as e:
                traceback.print_exc()
                site_summaries.append({"site": entry["name"],
                                       "members": entry["scenes"] or [],
                                       "error": repr(e)})
                failures += 1

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(render_html(summaries, sites=site_summaries))
    print(json.dumps({"report": out_path, "scenes": len(summaries),
                      "sites": len(site_summaries), "failures": failures}))
    return 1 if failures else 0


def main_entry(argv=None):
    """Console-script / python -m entry point."""
    raise SystemExit(main(argv))


if __name__ == "__main__":
    main_entry()
