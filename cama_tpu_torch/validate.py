"""Pixel-exactness validation of the PyTorch port (the north-star check of
SURVEY.md §4): compare overlay output across every path this package can
serve overlays through, and, when a checkout of the reference is given,
against the reference implementation itself, on any clip.  Counterpart of
cama_tpu/validate.py, with the same report.

    python -m cama_tpu_torch.validate --clip /path/to/clip [--source both]
        [--reference DIR] [--frames 10] [--kernel all] [--device cuda|cpu]
        [--out VALIDATE.json]

Defaults check every label source the clip carries and spread the checked
frames across the clip's head, middle and tail.  Reports per-source
per-path agreement with the host-exact frames (the reference's float64
chain, project_frame_exact, painted by cv2.circle): every path must agree
on more than 99.9 % of pixels, and the 'exact' path on all of them.  The
host-exact frames must be byte-identical to the reference where that is
present.

--device cuda (the default) runs the CUDA kernels and raises without a
card; --device cpu runs their plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from cama_tpu_torch.ops.geometry import project_frame_exact
from cama_tpu_torch.ops.raster import rasterize_exact_host
from cama_tpu_torch.pipeline import ClipPipeline, rasterize_cls_host


def host_exact_frames(pipe, source, frame_ids):
    """Reference-numerics overlays via the host float64 path + cv2 paint."""
    scene = pipe.scene
    fm = pipe.frame_matrices(source)
    fp = scene.flat[source]
    pts = fp.points[fp.valid]
    cls_ids = fp.cls[fp.valid]
    inst = fp.inst[fp.valid]
    h, w = scene.output_size
    out = {}
    for k, image_idx in enumerate(fm.frame_indices):
        if not fm.frame_valid[k] or int(image_idx) not in frame_ids:
            continue
        cam_outs = project_frame_exact(
            pts, np.linalg.inv(fm.chassis2world_f32[k]), scene.chassis2cam,
            scene.K_scaled, w, h,
        )
        frame = {}
        for c, cam in enumerate(scene.camera_list):
            vu, keep = cam_outs[c]
            base = pipe.undistorted_image(cam, int(image_idx))
            order = np.flatnonzero(keep)
            vu_list = []
            for i in np.unique(inst[order]):
                m = order[inst[order] == i]
                vu_list.append((fp.class_names[cls_ids[m[0]]], vu[m]))
            frame[cam] = rasterize_exact_host(base, vu_list, fp.class_names)
        out[int(image_idx)] = frame
    return out


def host_exact_rasters(pipe, source, frame_ids):
    """{image_idx: cls_raster [C, H, W] uint8} of the same float64 chain
    with no cv2: project_frame_exact per frame, floored to pixels, painted
    by pipeline.rasterize_cls_host (cv2.circle's radius-2 footprint, later
    point wins).  The anchor for checks at the raster level, where cv2 and
    camera images are not needed."""
    scene = pipe.scene
    fm = pipe.frame_matrices(source)
    fp = scene.flat[source]
    h, w = scene.output_size
    out = {}
    for k, image_idx in enumerate(fm.frame_indices):
        if not fm.frame_valid[k] or int(image_idx) not in frame_ids:
            continue
        cam_outs = project_frame_exact(
            fp.points, np.linalg.inv(fm.chassis2world_f32[k]),
            scene.chassis2cam, scene.K_scaled, w, h)
        keep = np.stack([keep_c & fp.valid for _, keep_c in cam_outs])
        with np.errstate(invalid="ignore"):
            vu = np.floor(np.nan_to_num(np.stack([vu_c for vu_c, _ in cam_outs]),
                                        nan=0.0, posinf=0.0, neginf=0.0))
        out[int(image_idx)] = rasterize_cls_host(np.where(keep[..., None], vu, 0.0),
                                                 keep, fp.cls, w, h)
    return out


def reference_frames(clip, source, frame_ids, reference_root):
    sys.path.insert(0, reference_root)
    from cama.dataset_reader import DatasetReader
    from cama.pose_transformer import PoseTransformer
    from cama.reproject import CameraManager, MapManager

    mm = MapManager()
    name = "map_labels.json" if source == "cama" else "map_nuscenes.json"
    with open(os.path.join(clip, "maps", name)) as f:
        labels = json.load(f)
    if source == "cama":
        bev = np.load(os.path.join(clip, "maps", "vision_road_mlp_ft.npy"))
        imap0 = mm.calculate_3d_instance_maps(bev, labels)
    else:
        imap0 = mm.load_3d_instance_maps(labels)
    dr = DatasetReader(clip)
    pt = PoseTransformer()
    if source == "cama":
        pt.loadarray(dr.get_odometry("scmv_camera_front.txt"))
        pt.right_rotate(dr.get_extrinsic("chassis", "camera_front"))
    else:
        pt.loadarray(dr.get_odometry("wigo_offset_clip.txt"))
        pt.normalize2center()
    cams = ["camera_front_left", "camera_front", "camera_front_right",
            "camera_rear_left", "camera_rear", "camera_rear_right"]
    cm_list = [CameraManager(clip, cam) for cam in cams]
    times = dr.get_sensor_timestamp("camera_front", sync=True)
    out = {}
    for image_idx in range(1, len(times)):
        if image_idx not in frame_ids:
            continue
        try:
            c2w = pt.seek_by_timestamp(times[image_idx], t_max_diff=0.5,
                                       interpolate=True).astype(np.float32)
        except RuntimeError:
            continue
        imap = mm.transform_3d_instance_maps(imap0, np.linalg.inv(c2w))
        imap = mm.crop_3d_instance_maps(imap)
        frame = {}
        for cm in cm_list:
            cam_map = mm.transform_3d_instance_maps(imap, cm.get_chassis2camera())
            maps_2d = cm.project_to_image(cam_map)
            image = cm.read_resized_image_by_index(image_idx)
            frame[cm.camera_name] = cm.render_maps(image, maps_2d)
        out[image_idx] = frame
    return out


def agreement(a, b):
    same = (a == b).all(axis=-1)
    return float(same.mean())


# every path the pipeline can serve overlays through: 'sparse' is the
# scatter-free host-paint stream, 'host_lane' the pure-NumPy float64 lane,
# 'exact' the bit-exact lane (f32 projection with ambiguity flags + selective
# f64 host recompute; it must report 1.0), 'two_stage' the 'compact' lane
# with the crop-first split forced, the rest the raster_kernel lanes
DEVICE_PATHS = ("compact", "two_stage", "scatter", "pallas", "fused",
                "sparse", "host_lane", "exact")


def forced_path_stream(scene, path_name, source, chunk=8, device="cuda"):
    """The named path forced to execute, never routed around by the
    sparse/dense decision or the two-stage heuristic (so that '--kernel
    compact' cannot validate the sparse host paint instead of the compact
    program).  Returns (pipeline, kind, stream): kind 'raster' streams
    (image_idx, cls_raster [C, H, W] uint8), kind 'sparse' streams
    (image_idx, vals [C, k], counts [C])."""
    kernel = {"sparse": "compact", "two_stage": "compact",
              "host_lane": "compact", "exact": "compact"}.get(path_name,
                                                              path_name)
    pipe = ClipPipeline(scene=scene, raster_kernel=kernel, chunk=chunk,
                        device=device)
    P = int(pipe.scene.flat[source].points.shape[0])
    if path_name == "exact":
        # f32 + flags on the device, flagged points recomputed in the
        # reference's f64 chain and patched before the raster; the contract
        # is 1.0 agreement, not 0.999
        return pipe, "raster", pipe.iter_overlay_rasters_exact(source)
    if path_name == "host_lane":
        return pipe, "raster", pipe.iter_overlay_rasters_host(source)
    if path_name == "sparse":
        # k = P: the deduped kept count can never exceed the point count, so
        # the per-frame dense-raster overflow fallback (which would validate
        # a dense program under the 'sparse' name) cannot engage
        def lists():
            for idx, vals, cnts in pipe.iter_sparse_points(source, k=P):
                if cnts.max() > P:
                    raise RuntimeError("sparse budget k=P overflowed")
                yield idx, vals, cnts

        return pipe, "sparse", lists()
    pipe.overlay_mode(source)  # sizes the lists
    if path_name == "two_stage":
        # force the crop-first program even when the heuristic says the
        # crop would not cull enough; P itself is always a safe budget
        if pipe._two_stage.get(source) is None:
            pipe._two_stage[source] = P
    elif path_name == "compact":
        pipe._two_stage[source] = None  # single-stage compact, provably
    # 'fused' needs no availability check here: the CUDA kernel keeps its
    # union list in global memory and its encodings in 32 bits, so it has
    # neither the on-chip list budget nor the 24-bit limit of the TPU kernel
    return pipe, "raster", pipe.iter_overlay_rasters(source)


def device_frames_for_path(scene, path_name, source, frame_ids, chunk=8,
                           device="cuda"):
    """{image_idx: {camera: overlay image}} of forced_path_stream's path
    over `frame_ids`, composited by the stream's own host paint."""
    pipe, kind, stream = forced_path_stream(scene, path_name, source, chunk,
                                            device)
    paint = (pipe.composite_frame_sparse if kind == "sparse"
             else pipe.composite_frame)
    return {idx: paint(source, idx, *payload)
            for idx, *payload in stream if idx in frame_ids}


def spread_frame_ids(valid_ids, n):
    """n frame ids spread across the clip: head, middle and tail (a
    head-only default would let tail-of-clip regressions slip by)."""
    if len(valid_ids) <= n:
        return set(valid_ids)
    picks = np.unique(np.linspace(0, len(valid_ids) - 1, n).round().astype(int))
    return {valid_ids[i] for i in picks}


def validate_source(pipe, source, frame_count, paths, reference_root):
    """Per-source validation report dict (see main)."""
    fm = pipe.frame_matrices(source)
    valid_ids = [int(i) for i, v in zip(fm.frame_indices, fm.frame_valid) if v]
    frame_ids = spread_frame_ids(valid_ids, frame_count)

    report = {"source": source, "frames": sorted(frame_ids)}
    if not frame_ids:
        report["error"] = "no valid frames in clip"
        return report
    exact = host_exact_frames(pipe, source, frame_ids)

    ref = None
    if reference_root and os.path.isdir(os.path.join(reference_root, "cama")):
        ref = reference_frames(pipe.scene.clip_path, source, frame_ids,
                               reference_root)
        ex = [int(np.array_equal(exact[i][c], ref[i][c])) for i in ref for c in ref[i]]
        report["host_exact_byte_identical_to_reference"] = bool(all(ex))

    report["paths"] = {}
    for path_name in paths:
        frames = device_frames_for_path(pipe.scene, path_name, source,
                                        frame_ids, chunk=pipe.chunk,
                                        device=pipe.device)
        entry = {"vs_host_exact_min_agreement": min(
            agreement(frames[i][c], exact[i][c])
            for i in frame_ids for c in frames[i])}
        if ref is not None:
            entry["vs_reference_min_agreement"] = min(
                agreement(frames[i][c], ref[i][c]) for i in ref for c in ref[i])
        report["paths"][path_name] = entry

    report["device_vs_host_exact_min_agreement"] = min(
        e["vs_host_exact_min_agreement"] for e in report["paths"].values())
    if ref is not None:
        report["device_vs_reference_min_agreement"] = min(
            e["vs_reference_min_agreement"] for e in report["paths"].values())
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description="Overlay pixel-exactness validation")
    parser.add_argument("--clip", required=True)
    parser.add_argument("--source", default="both",
                        choices=["cama", "nuscenes", "both"],
                        help="label source(s) to validate (default: every "
                             "source the clip carries)")
    parser.add_argument("--frames", type=int, default=10,
                        help="frames checked per source, spread across the "
                             "clip head/middle/tail")
    parser.add_argument("--reference", default=None,
                        help="checkout of the reference implementation "
                             "(the comparison is skipped when absent)")
    parser.add_argument("--kernel", default="all",
                        choices=("all",) + DEVICE_PATHS,
                        help="device path to validate (default: every path)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises without "
                             "a card) or 'cpu' (the kernels' plain PyTorch "
                             "versions)")
    parser.add_argument("--out", default=None,
                        help="also write the JSON report to this path")
    args = parser.parse_args(argv)

    paths = DEVICE_PATHS if args.kernel == "all" else (args.kernel,)
    pipe = ClipPipeline(clip_path=args.clip, device=args.device)
    if args.source == "both":
        sources = [s for s in ("cama", "nuscenes") if s in pipe.scene.flat]
    else:
        sources = [args.source]

    report = {"clip": args.clip, "sources": {}}
    for source in sources:
        report["sources"][source] = validate_source(
            pipe, source, args.frames, paths, args.reference)

    per_src = [r for r in report["sources"].values() if "paths" in r]
    ok = bool(per_src) and not any("error" in r for r in report["sources"].values())
    if per_src:
        report["device_vs_host_exact_min_agreement"] = min(
            r["device_vs_host_exact_min_agreement"] for r in per_src)
        ok = ok and report["device_vs_host_exact_min_agreement"] > 0.999
        # the exact lane's contract is bit-exactness, not 99.9 %
        exact_mins = [r["paths"]["exact"]["vs_host_exact_min_agreement"]
                      for r in per_src if "exact" in r.get("paths", {})]
        if exact_mins:
            report["exact_lane_min_agreement"] = min(exact_mins)
            ok = ok and report["exact_lane_min_agreement"] == 1.0
        with_ref = [r for r in per_src if "device_vs_reference_min_agreement" in r]
        if with_ref:
            report["device_vs_reference_min_agreement"] = min(
                r["device_vs_reference_min_agreement"] for r in with_ref)
            report["host_exact_byte_identical_to_reference"] = all(
                r.get("host_exact_byte_identical_to_reference", False)
                for r in per_src)
            ok = ok and report["host_exact_byte_identical_to_reference"]
    report["ok"] = ok
    out = json.dumps(report)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
