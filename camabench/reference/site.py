"""The CAMAv2 site (arXiv:2407.21331) from its member clips' files alone, in
float64: the merged map `main.py --config`'s `sites:` block writes, and
each member's Sim(3).

Per member: the CAMA labels lifted instance by instance (reference/scene.py's
lifting), and the Sim(3) from its SfM frame to the shared world frame by
Umeyama (with scale) of the chassis track the SfM poses give against the
ego odometry (odometry/wigo.txt) interpolated at the same times.  Then,
over the instances moved into the world frame:

- candidate pairs: same class, different members, bounding boxes within
  the tolerance; each instance subsampled once by its own draw of
  numpy's default_rng(0) (`choice` without replacement) when it has more
  points than the subsample, the mean of the instances' means
  subtracted;
- the refinement: a delta Sim(3) per member (rotation vector through the
  unnormalised Rodrigues formula, translation, log-scale) applied about
  the centroid of the subsampled points, member 0 held, by Adam (torch's
  defaults) on the mean over the pairs of the symmetric chamfer distance
  (the weighted mean of each point's distance to its nearest neighbour in
  the other set, both ways, halved; 1e-12 inside the square root), for
  the configured steps; the deltas are kept only when the final loss is
  below the first (the never-worse rule);
- the dedupe: the pairs within the dedupe tolerance, each pair's chamfer
  distance (no epsilon), an instance dropped when it is closer than the
  tolerance to an earlier instance that is kept.

Departures from the program, none of which changes a result beyond
rounding: the nearest neighbours are found without gradient and the
distances to them taken again with it (the program differentiates
through the minimum, which splits the gradient among tied minima; the
reference gives it to the first), the pairs run in blocks of PAIR_BLOCK
whatever the device, and everything stays float64 (`dtype`: the control
puts bfloat16 in the refinement's and the transforms' place).

Imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from camabench.reference import scene as ref_scene

PAIR_BLOCK = 1024  # pairs a block of the nearest-neighbour search


def lift_instances(labels, grid, map_size_m):
    """[(class, points [P, 3] float64)] of CAMA BEV-pixel polylines, one per
    instance that lifts to any point (reference/scene.py's lift_cama)."""
    out = []
    for inst in labels:
        if len(inst["data"]) <= 1:
            continue
        if not len(ref_scene._densify(np.asarray(inst["data"], np.float64))):
            continue
        pts, _ = ref_scene.lift_cama([inst], grid, map_size_m)
        out.append((inst["attrs"]["type"], pts))
    return out


def umeyama(x, y, dtype=np.float64):
    """(R [3, 3], t [3], s) minimising |y - (s R x + t)|^2 over the rows of
    x, y [n, 3] (Umeyama 1991, with scale), computed in `dtype`."""
    x, y = np.asarray(x, dtype), np.asarray(y, dtype)
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / len(x)
    u, d, vt = np.linalg.svd(cov)
    S = np.eye(3, dtype=dtype)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        S[2, 2] = -1.0
    R = u @ S @ vt
    s = np.trace(np.diag(d) @ S) / ((xc ** 2).sum() / len(x))
    t = my - s * R @ mx
    return R.astype(np.float64), t.astype(np.float64), float(s)


class Member:
    """One member clip: its ClipData (reference/scene.py) and its lifted
    instances (of the labels on disk, or of `labels` records)."""

    def __init__(self, path, cfg, labels=None):
        self.path = path
        size = (int(cfg["output_height"]), int(cfg["output_width"]))
        self.data = ref_scene.load_clip(path, cfg["cameras"], size, ("cama",),
                                        float(cfg["map_size_m"]))
        self.grid = np.load(os.path.join(path, "maps", "vision_road_mlp_ft.npy"))
        self.map_size_m = float(cfg["map_size_m"])
        if labels is None:
            with open(os.path.join(path, "maps", "map_labels.json")) as f:
                labels = json.load(f)
        self.instances = lift_instances(labels, self.grid, self.map_size_m)

    def sim3_to_world(self, dtype=np.float64):
        """(R, t, s) of p_world = s R p_sfm + t, Umeyama in `dtype`."""
        ts, T = self.data.pose_table["cama"]
        wts, W = ref_scene._read_tum(os.path.join(self.path, "odometry", "wigo.txt"))
        sfm, world = [], []
        for t, pose in zip(ts, T):
            w = ref_scene.interpolate_pose(wts, W, t)
            if w is not None:
                sfm.append(pose[:3, 3])
                world.append(w[:3, 3])
        return umeyama(np.asarray(sfm), np.asarray(world), dtype)


def subsampled(instances, subsample):
    """(pts [I, S, 3], w [I, S], center [3]) of instances [(class, world
    points, member)]: each instance's points, subsampled by its own draw,
    less the mean of the instances' means, and 1/n weights on real
    points."""
    I, S = len(instances), int(subsample)
    center = np.mean([p.mean(0) for _, p, _ in instances], axis=0)
    pts, w = np.zeros((I, S, 3)), np.zeros((I, S))
    for k, (_, p, _) in enumerate(instances):
        if len(p) > S:
            p = p[np.random.default_rng(0).choice(len(p), S, replace=False)]
        pts[k, :len(p)] = p - center
        w[k, :len(p)] = 1.0 / len(p)
    return pts, w, center


def candidate_pairs(instances, subsample, tol):
    """(pts [I, S, 3], w [I, S], ii, jj, clip [I], center [3]) of
    instances [(class, world points, member)]: `subsampled`, and the pairs
    (ii earlier, jj later) of one class, different members and bounding
    boxes within `tol`."""
    I = len(instances)
    pts, w, center = subsampled(instances, subsample)
    _, cls = np.unique([c for c, _, _ in instances], return_inverse=True)
    clip = np.asarray([m for _, _, m in instances])
    lo = np.stack([p.min(0) for _, p, _ in instances])
    hi = np.stack([p.max(0) for _, p, _ in instances])
    gap = (np.maximum(lo[:, None], lo[None, :]) - np.minimum(hi[:, None], hi[None, :])
           <= tol).all(-1)
    jj, ii = np.nonzero(np.tril(np.ones((I, I), bool), -1) & (cls[:, None] == cls[None, :])
                        & (clip[:, None] != clip[None, :]) & gap)
    return pts, w, ii, jj, clip, center


def _nearest(a, b, wa, wb):
    """(index in b of each point of a's nearest neighbour, index in a of
    each point of b's), real points only, without gradient, PAIR_BLOCK
    pairs at a time."""
    out_ab, out_ba = [], []
    with torch.no_grad():
        for s in range(0, len(a), PAIR_BLOCK):
            x, y = a[s:s + PAIR_BLOCK], b[s:s + PAIR_BLOCK]
            if x.dtype == torch.float64:  # ranks the neighbours alike, in fewer passes
                d2 = torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist")
            else:
                d2 = sum((x[:, :, None, k] - y[:, None, :, k]) ** 2 for k in range(3))
            inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
            out_ab.append(torch.where(wb[s:s + PAIR_BLOCK, None, :] > 0, d2, inf).argmin(2))
            out_ba.append(torch.where(wa[s:s + PAIR_BLOCK, :, None] > 0, d2, inf).argmin(1))
    return torch.cat(out_ab), torch.cat(out_ba)


def chamfer(a, b, wa, wb, eps=0.0):
    """[B] symmetric chamfer of point sets a, b [B, S, 3] with weights wa, wb
    [B, S] (0 on pads), differentiable in a and b."""
    iab, iba = _nearest(a, b, wa, wb)
    nb = torch.gather(b, 1, iab[:, :, None].expand(-1, -1, 3))
    na = torch.gather(a, 1, iba[:, :, None].expand(-1, -1, 3))
    dab = torch.sqrt(((a - nb) ** 2).sum(-1) + eps)
    dba = torch.sqrt(((b - na) ** 2).sum(-1) + eps)
    return 0.5 * ((dab * wa).sum(1) + (dba * wb).sum(1))


def objective(instances, ii, jj, subsample, device):
    """The refinement's objective at the instances' positions: the mean
    over the pairs (ii, jj) of the symmetric chamfer of their subsampled
    points (1e-12 inside the square root), float64."""
    pts, w, _ = subsampled(instances, subsample)
    dev = torch.device(device)
    P = torch.as_tensor(pts, dtype=torch.float64, device=dev)
    W = torch.as_tensor(w, dtype=torch.float64, device=dev)
    a, b = torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev)
    return float(chamfer(P[a], P[b], W[a], W[b], 1e-12).sum()) / len(ii)


def rodrigues(v):
    """[n, 3] rotation vectors -> [n, 3, 3], unnormalised: smooth at 0."""
    z = torch.zeros_like(v[:, 0])
    K = torch.stack([torch.stack([z, -v[:, 2], v[:, 1]], -1),
                     torch.stack([v[:, 2], z, -v[:, 0]], -1),
                     torch.stack([-v[:, 1], v[:, 0], z], -1)], -2)
    theta2 = (v * v).sum(-1) + 1e-16
    theta = torch.sqrt(theta2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return (eye + (torch.sin(theta) / theta)[:, None, None] * K
            + ((1 - torch.cos(theta)) / theta2)[:, None, None] * (K @ K))


def refine(pts, w, ii, jj, clip, n_members, iters, lr, device, dtype=torch.float64):
    """(deltas (rot, t, log_s) float64 arrays or None, losses [iters] (the
    objective at the start of each step), final loss, local centroid [3])
    of the refinement over the pairs (ii, jj)."""
    dev = torch.device(device)

    def put(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=dev, dtype=dt)

    P, W = put(pts), put(w)
    valid = w.reshape(-1) > 0
    center = put(pts.reshape(-1, 3)[valid].mean(0))
    ci = put(clip, torch.int64)
    ii_t, jj_t = put(ii, torch.int64), put(jj, torch.int64)
    params = {k: torch.zeros(shape, dtype=dtype, device=dev, requires_grad=True)
              for k, shape in (("rot", (n_members, 3)), ("t", (n_members, 3)),
                               ("log_s", (n_members,)))}
    opt = torch.optim.Adam(params.values(), lr=lr)
    free = (torch.arange(n_members, device=dev) != 0).to(dtype)

    def loss():
        R, s = rodrigues(params["rot"]), torch.exp(params["log_s"])
        moved = (s[ci][:, None, None] * ((P - center) @ R[ci].transpose(1, 2))
                 + center + params["t"][ci][:, None, :])
        return chamfer(moved[ii_t], moved[jj_t], W[ii_t], W[jj_t], 1e-12).sum() / len(ii)

    values = []
    for _ in range(iters):
        opt.zero_grad()
        value = loss()
        value.backward()
        with torch.no_grad():
            for p in params.values():
                p.grad.mul_(free if p.dim() == 1 else free[:, None])
        opt.step()
        values.append(value.detach())
    with torch.no_grad():
        final = float(loss())
    center = center.double().cpu().numpy()
    losses = torch.stack(values).double().cpu().numpy() if values else np.zeros(0)
    if not len(losses) or final >= losses[0]:
        return None, losses, (final if not len(losses) else losses[0]), center
    return tuple(params[k].detach().double().cpu().numpy() for k in ("rot", "t", "log_s")), \
        losses, final, center


def _rodrigues_np(v):
    return rodrigues(torch.as_tensor(np.asarray(v, np.float64)[None]))[0].numpy()


def apply_deltas(instances, sim3, deltas, pivot, dtype=torch.float64):
    """(instances, sim3) with each member's delta Sim(3) applied about the
    world point `pivot`: p' = sd Rd (p - pivot) + pivot + td.  The
    instances' transform runs in `dtype` on coordinates less the pivot."""
    rot, tns, lgs = deltas
    Rd = [_rodrigues_np(r) for r in rot]
    sd = np.exp(np.asarray(lgs, np.float64))
    td = np.asarray(tns, np.float64)
    new_sim3 = [(Rd[c] @ R, sd[c] * (Rd[c] @ (t - pivot)) + pivot + td[c], sd[c] * s)
                for c, (R, t, s) in enumerate(sim3)]
    out = []
    for cls, p, c in instances:
        q = torch.as_tensor(p - pivot).to(dtype)
        moved = (float(sd[c]) * (q @ torch.as_tensor(Rd[c].T).to(dtype))
                 + torch.as_tensor(td[c]).to(dtype))
        out.append((cls, moved.double().numpy() + pivot, c))
    return out, new_sim3


def dedupe_keep(instances, tol, subsample, device):
    """Keep mask [I]: an instance goes when its chamfer distance to an
    earlier kept instance of its candidate pairs is under `tol`."""
    I = len(instances)
    keep = np.ones(I, bool)
    pts, w, ii, jj, _, _ = candidate_pairs(instances, subsample, tol)
    if not len(ii):
        return keep, 0
    dev = torch.device(device)
    P = torch.as_tensor(pts, dtype=torch.float64, device=dev)
    W = torch.as_tensor(w, dtype=torch.float64, device=dev)
    a, b = torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev)
    d = chamfer(P[a], P[b], W[a], W[b]).cpu().numpy()
    close = np.zeros((I, I), bool)
    close[jj, ii] = d < tol
    for j in range(I):
        if close[j, :j][keep[:j]].any():
            keep[j] = False
    return keep, len(ii)


@contextlib.contextmanager
def _no_tf32():
    """float32 matrix products in float32, not TF32, while the reference
    runs (its float64 work is untouched by TF32 either way); the caller's
    settings are put back after."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda, cudnn


def build(members, cfg, device, dtype=torch.float64, refine_it=True):
    """The site of `members` (Member, in the site's order): a dict of
    sim3_initial and sim3 ([(R, t, s)] per member, before and after the
    refinement), refined [(class, world points, member)] every instance
    after the refinement, keep [I] the dedupe's mask over them, instances
    those it keeps, losses (the refinement's objective at the start of
    each step), loss_first / loss_final, refine_pairs and pairs (ii, jj),
    dedupe_pairs, removed.  `dtype` is the refinement's and the transforms'
    precision."""
    with _no_tf32():
        return _build(members, cfg, device, dtype, refine_it)


def _build(members, cfg, device, dtype, refine_it):
    site = cfg["site"]
    sim3 = [member.sim3_to_world() for member in members]
    instances = moved(members, sim3)
    out = {"sim3_initial": list(sim3), "losses": np.zeros(0), "loss_first": 0.0,
           "loss_final": 0.0, "refine_pairs": 0}
    ref = site["refine"]
    if refine_it and len(members) > 1:
        pts, w, ii, jj, clip, world_center = candidate_pairs(
            instances, ref["subsample"], ref["tol_m"])
        out["refine_pairs"], out["pairs"] = len(ii), (ii, jj)
        if len(ii):
            deltas, losses, final, local = refine(
                pts, w, ii, jj, clip, len(members), int(ref["iters"]), float(ref["lr"]),
                device, dtype)
            out["losses"], out["loss_final"] = losses, final
            out["loss_first"] = float(losses[0]) if len(losses) else final
            if deltas is not None:
                instances, sim3 = apply_deltas(instances, sim3, deltas,
                                               world_center + local, dtype)
    dd = site["dedupe"]
    keep, out["dedupe_pairs"] = dedupe_keep(instances, dd["tol_m"], dd["subsample"], device)
    out["removed"] = int((~keep).sum())
    out["refined"], out["keep"] = instances, keep
    out["instances"] = [inst for inst, k in zip(instances, keep) if k]
    out["sim3"] = sim3
    return out


def member_points(instances, sim3):
    """(points [P, 3] float64, lane [P] bool) of merged instances [(class,
    world points, member)] in the frame of the member whose Sim(3) is
    `sim3` (R, t, s): p_sfm = R^T (p - t) / s."""
    R, t, s = sim3
    pts = [((np.asarray(p, np.float64) - t) @ np.asarray(R)) / s for _, p, _ in instances]
    lane = [np.full(len(p), cls == "lane_marking") for cls, p, _ in instances]
    if not pts:
        return np.zeros((0, 3)), np.zeros(0, bool)
    return np.concatenate(pts), np.concatenate(lane)


def moved(members, sim3):
    """[(class, world points, member)] of the members' lifted instances
    through the Sim(3)s `sim3` [(R, t, s)] (float64)."""
    return [(cls, s * (p @ np.asarray(R).T) + t, m)
            for m, (member, (R, t, s)) in enumerate(zip(members, sim3))
            for cls, p in member.instances]


def map_gap(kept, refined, keep):
    """The largest xy distance between the merged map `kept` [(class,
    points, member)] and the instances of a refined map `refined` that
    `keep` marks, paired in order; inf when `kept` holds other instances
    (another number of them, or another class, point count or member)."""
    ref = [inst for inst, k in zip(refined, keep) if k]
    if len(ref) != len(kept):
        return float("inf")
    worst = 0.0
    for (ca, pa, ma), (cb, pb, mb) in zip(kept, ref):
        pa, pb = np.asarray(pa, np.float64), np.asarray(pb, np.float64)
        if ca != cb or ma != mb or len(pa) != len(pb):
            return float("inf")
        if len(pa):
            worst = max(worst, float(np.linalg.norm(pa[:, :2] - pb[:, :2], axis=1).max()))
    return worst
