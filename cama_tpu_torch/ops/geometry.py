"""Per-frame matrix composition on the host (float64), and the device
projection of points into every frame and camera (float32).

The host half copies cama_tpu/ops/geometry.py's, which cannot be imported
without jax; the pose seek comes from cama_tpu_torch.se3.  Pose chains stay
in float64 on the host; only the composed matrices are cast to float32 for
the device.  Bit-identical to the JAX package's functions
(tests/test_torch_pipeline.py).

`project_frames` is the counterpart of the JAX einsum projection.  Every
device lane of this package projects with the same elementwise order,
((m0*x + m1*y) + m2*z) + m3 with IEEE division, so the CUDA kernels
(csrc/project.cuh) and their plain versions keep the same points bit for
bit on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cama_tpu_torch.ops.lift import CROP_BOX
from cama_tpu_torch.ops.raster import compact_rows
from cama_tpu_torch.se3 import apply_seek, seek_indices

MAX_CAM = 8  # cameras per frame the projection kernels hold on chip


@dataclass
class FrameMatrices:
    """Host-composed per-frame matrices feeding the device pipeline."""

    A: np.ndarray  # [F, 4, 4] world -> chassis (crop frame)
    B: np.ndarray  # [F, C, 3, 4] world -> scaled pixel (pre-division)
    frame_valid: np.ndarray  # [F] bool (pose seek succeeded)
    frame_indices: np.ndarray  # [F] int (image index in the sync table)
    chassis2world_f32: np.ndarray  # [F, 4, 4] float32 (reference-parity cast)


def compose_frame_matrices(
    trajectory,
    frame_times,
    chassis2cam,
    K_scaled,
    t_max_diff=0.5,
    start_index=1,
):
    """Seek chassis2world at each frame time and build A/B (host, float64).

    The reference chain: seek + SLERP, cast to float32, invert, then fold the
    static chassis->camera extrinsic and the scaled K into one 3x4 per
    camera.  Frames before `start_index` are skipped like the reference.

    Args:
        trajectory: se3.Trajectory holding chassis2world poses
        frame_times: [Nall] seconds (sync table of the main camera)
        chassis2cam: [C, 4, 4] float64
        K_scaled:    [C, 3, 3] float64 (already rescaled to output size)
    """
    frame_times = np.asarray(frame_times, dtype=np.float64)[start_index:]
    frame_indices = np.arange(len(frame_times)) + start_index
    T_all = trajectory.as_transform(True)
    ts = trajectory.timestamps[:, 0]
    idx = seek_indices(ts, frame_times, t_max_diff, interpolate=True)
    c2w = apply_seek(T_all, idx).astype(np.float32)  # reference casts to f32
    valid = idx["valid"]

    # world->chassis: the reference inverts the float32 matrix; replicate
    # that bit pattern, then promote
    with np.errstate(all="ignore"):
        w2c_f32 = np.linalg.inv(np.where(valid[:, None, None], c2w,
                                         np.eye(4, dtype=np.float32)))
    A = w2c_f32.astype(np.float64)

    chassis2cam = np.asarray(chassis2cam, dtype=np.float64)
    K_scaled = np.asarray(K_scaled, dtype=np.float64)
    # K_tilde [C, 3, 4]: pinhole projection of homogeneous camera-frame points
    K_tilde = np.concatenate([K_scaled, np.zeros((len(K_scaled), 3, 1))], axis=-1)
    # B[f, c] = K_tilde[c] @ chassis2cam[c] @ A[f]
    B = np.einsum("cij,cjk,fkl->fcil", K_tilde, chassis2cam, A)
    return FrameMatrices(
        A=A,
        B=B,
        frame_valid=valid,
        frame_indices=frame_indices,
        chassis2world_f32=c2w,
    )


def crop_bounds(crop=None):
    """(lo, hi) float32 [3] corners of the chassis-frame crop box."""
    crop = crop or CROP_BOX
    lo = np.array([crop["x_min"], crop["y_min"], crop["z_min"]], dtype=np.float32)
    hi = np.array([crop["x_max"], crop["y_max"], crop["z_max"]], dtype=np.float32)
    return lo, hi


def _row(m, x, y, z):
    """((m0*x + m1*y) + m2*z) + m3 over the last axis of m [..., 4], broadcast
    against the point coordinates [P] -> [..., P]."""
    return ((m[..., 0, None] * x + m[..., 1, None] * y)
            + m[..., 2, None] * z) + m[..., 3, None]


def project_frames(points, valid, A, B, frame_valid, width, height, crop_lo,
                   crop_hi):
    """Project all points into all frames x cameras (plain PyTorch, any
    device).

    Args:
        points [P, 3] f32, valid [P] bool
        A [F, 4, 4] f32 world -> chassis, B [F, C, 3, 4] f32 world -> pixel
        frame_valid [F] bool
        width/height: output image size; crop_lo/crop_hi: [3] chassis box
            (inclusive)
    Returns:
        vu [F, C, P, 2] f32 (v, u) and keep [F, C, P] bool — crop & z > 0 &
        in-bounds & valid & frame_valid.
    """
    ok = crop_mask(points, valid, A, frame_valid, crop_lo, crop_hi)
    vu, keep = _camera_pixels(B, points[:, 0], points[:, 1], points[:, 2],
                              width, height)
    return vu, keep & ok[:, None, :]


def crop_mask(points, valid, A, frame_valid, crop_lo, crop_hi):
    """[F, P] bool: the valid points of the valid frames inside the
    inclusive chassis crop box, with project_frames' elementwise order."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    ok = valid[None, :] & frame_valid[:, None]
    for r in range(3):
        cr = _row(A[:, r], x, y, z)
        ok = ok & (cr >= float(crop_lo[r])) & (cr <= float(crop_hi[r]))
    return ok


def _camera_pixels(B, x, y, z, width, height):
    """(vu [F, C, N, 2], keep [F, C, N]: z > 0 and in the image) of points
    x, y, z (each [N], or [F, 1, N]) under B [F, C, 3, 4]."""
    px = _row(B[:, :, 0], x, y, z)
    py = _row(B[:, :, 1], x, y, z)
    pz = _row(B[:, :, 2], x, y, z)
    mask_z = pz > 0
    safe_z = torch.where(mask_z, pz, torch.ones_like(pz))
    u = px / safe_z
    v = py / safe_z
    keep = mask_z & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return torch.stack([v, u], dim=-1), keep


def crop_compact_project_idx(points, valid, A, B, frame_valid, width, height,
                             crop_lo, crop_hi, k1):
    """Two-stage stages 1 and 2 for a chunk of frames: the camera-
    independent crop test, a stable compaction of its survivors to k1
    slots per frame, then the camera projection of those survivors only.
    Counterpart of cama_tpu/ops/geometry.py:crop_compact_project_idx (one
    frame there, F here), with project_frames' elementwise order, so a
    survivor keeps exactly the pixel and keep bits project_frames gives it.

    Returns (vu [F, C, k1, 2], keep [F, C, k1], idx [F, k1] int64 point
    indices in original order; padding slots carry index 0 with keep
    False, and survivors past k1 are dropped) and the crop count [F]
    int32, which callers hold against k1."""
    sel = crop_mask(points, valid, A, frame_valid, crop_lo, crop_hi)
    P = points.shape[0]
    order = torch.arange(P, dtype=torch.int32, device=points.device)
    idx = compact_rows(order.expand(sel.shape[0], P), sel, k1)
    sel_valid = idx >= 0
    idx = torch.where(sel_valid, idx, 0).to(torch.int64)
    pts = points[idx]                                      # [F, k1, 3]
    vu, keep = _camera_pixels(B, pts[:, None, :, 0], pts[:, None, :, 1],
                              pts[:, None, :, 2], width, height)
    return (vu, keep & sel_valid[:, None, :], idx,
            sel.sum(dim=-1, dtype=torch.int32))


def crop_compact_project(points, valid, cls, A, B, frame_valid, width, height,
                         crop_lo, crop_hi, k1):
    """crop_compact_project_idx with the class ids gathered through the
    selection: (vu [F, C, k1, 2], keep [F, C, k1], cls_sel [F, k1], crop
    count [F])."""
    vu, keep, idx, n_crop = crop_compact_project_idx(
        points, valid, A, B, frame_valid, width, height, crop_lo, crop_hi, k1)
    return vu, keep, cls[idx], n_crop


def check_frame_inputs(points, valid, A, B, frame_valid, cls=None):
    """Validate a kernel's projection inputs: dtypes, shapes, one device and
    1..MAX_CAM cameras.  Returns (P, F, C)."""
    P = points.shape[0]
    F, C = B.shape[0], B.shape[1]
    if not 1 <= C <= MAX_CAM:
        raise ValueError(f"the projection kernels support 1..{MAX_CAM} "
                         f"cameras, got {C}")
    if P < 1:
        raise ValueError("the projection kernels need at least one point")
    expect = {"points": (points, (P, 3), torch.float32),
              "valid": (valid, (P,), torch.bool),
              "A": (A, (F, 4, 4), torch.float32),
              "B": (B, (F, C, 3, 4), torch.float32),
              "frame_valid": (frame_valid, (F,), torch.bool)}
    if cls is not None:
        expect["cls"] = (cls, (P,), torch.int32)
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on {points.device}")
    return P, F, C


def route(t, kernel):
    """'cuda' for a CUDA tensor (launch the kernel), 'cpu' for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no {kernel} implementation for {t.device}")


# ---------------------------------------------------------------------------
# Double-f32 (compensated) arithmetic for the bit-exact lane, the counterpart
# of cama_tpu/ops/geometry.py's: error-free transformations give each dot
# product a (value, error) pair accurate to ~eps32^2 relative, so ambiguity
# flags fire only on genuine boundary-sitters.
#
# TwoSum and TwoProd hold only if every elementary op is IEEE-rounded exactly
# as written.  PyTorch runs these eagerly, one rounded op per kernel, so each
# op below is its own tensor op: no addcmul/addcdiv/lerp, no `alpha=`, no
# matmul/einsum, no torch.compile and no fused kernel, any of which could
# contract a multiply and an add into one FMA.  (The JAX package wraps each op
# in an optimization barrier and probes its jit compiler for the same reason;
# neither has a counterpart here.)
# ---------------------------------------------------------------------------

_SPLIT = 4097.0  # 2^12 + 1, Dekker's splitter for a 24-bit significand


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(x):
    c = x * _SPLIT
    hi = c - (c - x)
    return hi, x - hi


def _two_prod(a, b):
    """Dekker TwoProd via 12-bit splitting: p + e == a * b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
    return p, e


def _df_dot4(row, p4, row_lo=None):
    """Compensated 4-term dot (Ogita-Rump-Oishi Dot2): (s, e) with
    s + e == sum_j row[..., j] * p4[..., j] to ~eps32^2 relative accuracy.
    row and p4 broadcast against each other with a trailing axis of 4.

    row_lo carries the f32-cast residual of a matrix that was composed in
    f64 (row_true = row + row_lo): its products are ~eps32 of the main
    terms and land in the error channel with plain f32 accumulation."""
    shape = torch.broadcast_shapes(row.shape[:-1], p4.shape[:-1])
    s = torch.zeros(shape, dtype=torch.float32, device=p4.device)
    e = s
    for j in range(4):
        pj, pe = _two_prod(row[..., j], p4[..., j])
        s, se = _two_sum(s, pj)
        e = e + (se + pe)
        if row_lo is not None:
            e = e + row_lo[..., j] * p4[..., j]
    return s, e


def _df_div(xs, xe, zs, ze):
    """Double-f32 division (xs+xe)/(zs+ze) -> (q1, q2) with one Newton
    correction: q2 captures the residual of q1 = fl(xs/zs)."""
    q1 = xs / zs
    p, pe = _two_prod(q1, zs)
    r = (((xs - p) - pe) + xe) - q1 * ze
    return q1, r / zs


def _df_frac_dist(q1, q2):
    """(floor, distance to the nearest integer line) of the double-f32 value
    q1 + q2.  |q1| < 2^23 makes q1 - floor(q1) exact, so the fractional part
    frac + q2 carries the full compensated accuracy near 0 and 1."""
    fl = torch.floor(q1)
    frac = (q1 - fl) + q2
    fl = fl + torch.floor(frac)  # q2 can push across the line
    frac = frac - torch.floor(frac)
    return fl, torch.minimum(frac, 1.0 - frac)


#: absolute bands around decision boundaries (refined-value space): a point
#: whose compensated value sits closer than this to a boundary is flagged
#: even when f32 and refined quantize identically — the band absorbs the
#: ~eps32^2 residual of the compensation and the host chain's own f64
#: rounding, with orders of magnitude to spare.
AMBIGUITY_BAND_PX = 1e-4  # pixels (u/v floor + image-bounds lines)
AMBIGUITY_BAND_M = 1e-6   # meters (crop box planes, z>0 plane)


def _compensated_frame(p4, Af, Bf, Bf_lo):
    """The double-f32 half of one frame: crop coordinates (cs, ce) [3, P],
    projection rows (ps, pe) [C, 3, P], the z > band guard z_ok [C, P] and
    the pixel quotients (u1, u2), (v1, v2) [C, P] — the op sequence of
    cama_tpu/ops/geometry.py:_checked_frame, bit for bit."""
    cs, ce = _df_dot4(Af[:3, None, :], p4[None, :, :])
    ps, pe = _df_dot4(Bf[:, :, None, :], p4[None, None, :, :],
                      row_lo=Bf_lo[:, :, None, :])
    zs, ze = ps[:, 2], pe[:, 2]
    # guard the division away from the z~0 set (flagged anyway)
    z_ok = (zs + ze).abs() > AMBIGUITY_BAND_M
    zs_safe = torch.where(z_ok, zs, 1.0)
    ze_safe = torch.where(z_ok, ze, 0.0)
    u1, u2 = _df_div(ps[:, 0], pe[:, 0], zs_safe, ze_safe)
    v1, v2 = _df_div(ps[:, 1], pe[:, 1], zs_safe, ze_safe)
    return cs, ce, ps, pe, z_ok, u1, u2, v1, v2


def _checked_frame(p4, valid, Af, Bf, Bf_lo, fv, vu, keep, width, height,
                   crop_lo, crop_hi):
    """One frame's ambiguity flags amb [P]: the production f32 values
    (vu [C, P, 2], keep [C, P], from project_frames) against the compensated
    double-f32 ones.  fv is the frame's frame_valid, a 0-d bool tensor."""
    cs, ce, ps, pe, z_ok, u1, u2, v1, v2 = _compensated_frame(p4, Af, Bf,
                                                              Bf_lo)
    xyz_r = cs + ce                                           # [3, P]
    in_crop_r = near_crop = None
    for r in range(3):
        lo, hi = float(crop_lo[r]), float(crop_hi[r])
        inside = (xyz_r[r] >= lo) & (xyz_r[r] <= hi)
        near = (((xyz_r[r] - lo).abs() <= AMBIGUITY_BAND_M)
                | ((xyz_r[r] - hi).abs() <= AMBIGUITY_BAND_M))
        in_crop_r = inside if in_crop_r is None else in_crop_r & inside
        near_crop = near if near_crop is None else near_crop | near
    z_r = ps[:, 2] + pe[:, 2]
    mask_z_r = z_r > 0
    near_z = ~z_ok
    ufl, udist = _df_frac_dist(u1, u2)
    vfl, vdist = _df_frac_dist(v1, v2)
    u_r = u1 + u2
    v_r = v1 + v2
    in_img_r = (u_r >= 0) & (u_r < width) & (v_r >= 0) & (v_r < height)
    relevant = valid[None, :] & fv
    keep_r = mask_z_r & in_img_r & in_crop_r[None, :] & relevant

    keep_flip = keep != keep_r
    # pixel floor: the raster truncates (== floor for the kept u, v >= 0);
    # only matters where the point paints on either side
    pix_flip = (keep | keep_r) & ((torch.floor(vu[..., 1]) != ufl)
                                  | (torch.floor(vu[..., 0]) != vfl))
    # boundary bands fire on any point that plausibly passes the other
    # guards on the refined side, ungated by `keep`: a point the device
    # rejects at u = -1e-5 can still be kept by the host's f64 chain
    near_line = (udist <= AMBIGUITY_BAND_PX) | (vdist <= AMBIGUITY_BAND_PX)
    near_any = near_z | near_crop[None, :] | near_line
    plaus = (relevant
             & (mask_z_r | near_z)
             & (in_crop_r[None, :] | near_crop[None, :])
             & (u_r >= -1.0) & (u_r < width + 1.0)
             & (v_r >= -1.0) & (v_r < height + 1.0))
    return (keep_flip | pix_flip | (plaus & near_any)).any(dim=0)


def project_frames_checked(points, valid, A, B, B_lo, frame_valid, width,
                           height, crop_lo, crop_hi):
    """project_frames plus per-point ambiguity flags, for the bit-exact
    lane (plain PyTorch, any device); counterpart of
    cama_tpu/ops/geometry.py:project_frames_checked.

    Each point is projected twice: with the production f32 formula (this
    package's project_frames, the values every raster lane consumes), and in
    compensated double-f32 (error-free transformations plus B_lo, the
    residual the f32 cast of the f64-composed B rounded away).  A point is
    flagged when a keep guard (crop box, z > 0, image bounds) or the pixel
    floor differs between the two, or when the refined value sits within
    AMBIGUITY_BAND_* of a boundary: exactly the points whose f32 result
    could disagree with the reference's f64 chain.  The exact lane
    (pipeline.iter_overlay_rasters_exact) recomputes only those on the host.

    The compensated half runs frame by frame (its [C, 3, P] temporaries are
    many) as some hundreds of small elementwise ops per frame.

    Returns (vu [F, C, P, 2], keep [F, C, P], amb [F, P]); amb is collapsed
    over cameras because the host recompute projects a point into all
    cameras in one call."""
    vu, keep = project_frames(points, valid, A, B, frame_valid, width, height,
                              crop_lo, crop_hi)
    p4 = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    amb = torch.stack([
        _checked_frame(p4, valid, A[f], B[f], B_lo[f], frame_valid[f], vu[f],
                       keep[f], width, height, crop_lo, crop_hi)
        for f in range(A.shape[0])])
    return vu, keep, amb


# ---------------------------------------------------------------------------
# Host-exact golden path: the reference's per-frame NumPy chain, mixed
# f32/f64 promotion included (a copy of
# cama_tpu/ops/geometry.py:project_frame_exact; the dtypes are load-bearing).
# ---------------------------------------------------------------------------


def project_frame_exact(points_f32_or_f64, A_f32, chassis2cam, K_scaled, width, height,
                        crop=None):
    """One frame, all cameras, NumPy with the reference's exact dtype chain:
    float32 world2chassis @ float64-promoted homogeneous points, crop, then
    per-camera float64 extrinsic + K, divide, mask.  Returns per-camera
    (vu [Pi, 2] float64 arrays, keep masks) without padding.

    points: [P, 3]; A_f32: [4, 4] float32; chassis2cam: [C, 4, 4] float64;
    K_scaled: [C, 3, 3] float64.
    """
    crop = crop or CROP_BOX
    pts = np.asarray(points_f32_or_f64)
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=-1)  # promotes to f64
    chassis = (A_f32 @ ph.T).T[:, :3]
    m = (
        (chassis[:, 0] >= crop["x_min"]) & (chassis[:, 0] <= crop["x_max"])
        & (chassis[:, 1] >= crop["y_min"]) & (chassis[:, 1] <= crop["y_max"])
        & (chassis[:, 2] >= crop["z_min"]) & (chassis[:, 2] <= crop["z_max"])
    )
    out = []
    for c in range(len(chassis2cam)):
        ch_h = np.concatenate([chassis, np.ones((len(chassis), 1))], axis=-1)
        cam = (chassis2cam[c] @ ch_h.T).T[:, :3]
        proj = (K_scaled[c] @ cam.T).T
        mask_z = proj[:, 2] > 0
        with np.errstate(all="ignore"):
            div = proj / proj[:, 2:]
        keep = (
            m & mask_z & (div[:, 2] > 0)
            & (div[:, 0] >= 0) & (div[:, 0] < width)
            & (div[:, 1] >= 0) & (div[:, 1] < height)
        )
        out.append((div[:, [1, 0]], keep))
    return out
