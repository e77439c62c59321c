"""All-camera projection of a chunk of frames: the `'pallas'` lane's front
end.

Counterpart of cama_tpu/ops/pallas_project.py, whose Pallas kernel projects
one frame's point tiles into every camera on the TPU.  The function keeps
its JAX name because users select the lane as raster_kernel='pallas'.
`project_frame_pallas` launches the hand-written CUDA kernel
(csrc/pallas_project.cu) for CUDA tensors, one launch per chunk of frames,
and runs the plain version `project_frame_pallas_ref` (which is
ops.geometry.project_frames) only for CPU tensors.  Both follow
project_frames' elementwise order, so they agree bit for bit on the card;
unlike the TPU kernel, P needs no padding to a tile multiple.
"""
from __future__ import annotations

import torch

from cama_tpu_torch.ops.geometry import check_frame_inputs, project_frames, route

# launches of the CUDA kernel, counted by its wrapper (plain-version calls on
# CPU tensors do not count)
LAUNCHES = {"project_frame_pallas": 0}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


project_frame_pallas_ref = project_frames


def _launch(points, valid, A, B, frame_valid, width, height, crop_lo,
            crop_hi):
    from cama_tpu_torch import _build

    P, F, C = check_frame_inputs(points, valid, A, B, frame_valid)
    lib = _build.load()
    dev = points.device
    pts = points.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    fv_u8 = frame_valid.to(torch.uint8).contiguous()
    A_c, B_c = A.contiguous(), B.contiguous()
    vu = torch.empty((F, C, P, 2), dtype=torch.float32, device=dev)
    keep = torch.empty((F, C, P), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.cama_pp_project(
            pts.data_ptr(), valid_u8.data_ptr(), fv_u8.data_ptr(),
            A_c.data_ptr(), B_c.data_ptr(), P, F, C, int(width), int(height),
            *(float(v) for v in crop_lo), *(float(v) for v in crop_hi),
            vu.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"project_frame_pallas: CUDA launch failed with error {err}")
    LAUNCHES["project_frame_pallas"] += 1
    return vu, keep.view(torch.bool)


def project_frame_pallas(points, valid, A, B, frame_valid, width, height,
                         crop_lo, crop_hi):
    """Project a chunk of frames' points into every camera.

    Args:
        points [P, 3] f32, valid [P] bool
        A [F, 4, 4] f32 world -> chassis, B [F, C, 3, 4] f32 world -> pixel
        frame_valid [F] bool
        width/height: output image size; crop_lo/crop_hi: [3] chassis box
    Returns:
        vu [F, C, P, 2] f32 (v, u) and keep [F, C, P] bool, project_frames'
        contract.  CUDA tensors launch the kernel (or raise); CPU tensors
        run the plain version."""
    if route(points, "project_frame_pallas") == "cpu":
        check_frame_inputs(points, valid, A, B, frame_valid)
        return project_frame_pallas_ref(points, valid, A, B, frame_valid,
                                        width, height, crop_lo, crop_hi)
    return _launch(points, valid, A, B, frame_valid, width, height, crop_lo,
                   crop_hi)
