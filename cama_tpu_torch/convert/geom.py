"""2-D geometry backend for map vectorization (convert/vecmap.py); the
PyTorch port's own copy of cama_tpu/convert/geom.py (pure NumPy).

The reference leans on shapely (dataset/nuscenes2clip.py:10-11) for patch
clipping, polygon union, and ring extraction.  shapely is an optional
dependency here: when importable, `union_polygons` delegates to shapely
automatically (reference-parity path) and `shapely_backend()` additionally
exposes a shapely linemerge; the default pure-NumPy backend provides:

  * polyline clip to an axis-aligned box (exact, splits at exits)
  * polygon clip via Sutherland-Hodgman (exact for the convex box window)
  * general polygon union via planar arrangement (`union_polygons`) — exact
    for arbitrary, possibly partially-overlapping polygons with holes: every
    edge is split at every intersection, each sub-edge is classified by
    coverage on its two sides, and the boundary is face-traced into rings
  * greedy endpoint linemerge, signed-area orientation

Geometries are plain numpy arrays: polylines [N, 2]; polygons are
(exterior [N, 2], [holes...]) tuples with unclosed rings.
"""
from __future__ import annotations

import numpy as np

try:
    import shapely  # noqa: F401

    HAVE_SHAPELY = True
except ImportError:
    HAVE_SHAPELY = False


def rotate_points(pts, angle_deg, origin):
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s], [s, c]])
    o = np.asarray(origin, dtype=np.float64)
    return (np.asarray(pts, dtype=np.float64) - o) @ R.T + o


def translate_points(pts, dx, dy):
    return np.asarray(pts, dtype=np.float64) + np.array([dx, dy])


def signed_area(ring):
    ring = np.asarray(ring, dtype=np.float64)
    x, y = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    return 0.5 * np.sum(x * y2 - x2 * y)


def is_ccw(ring):
    return signed_area(ring) > 0


# ---------------------------------------------------------------------------
# numpy backend primitives
# ---------------------------------------------------------------------------


def clip_polyline_to_box(pts, minx, miny, maxx, maxy):
    """Exact polyline ∩ box: list of sub-polylines (each [K>=2, 2])."""
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) < 2:
        return []
    out, cur = [], []

    def inside(p):
        return minx <= p[0] <= maxx and miny <= p[1] <= maxy

    def clip_seg(p, q):
        """Liang-Barsky: returns (t0, t1) in [0,1] of the inside part, or None."""
        d = q - p
        t0, t1 = 0.0, 1.0
        for dim, lo, hi in ((0, minx, maxx), (1, miny, maxy)):
            if abs(d[dim]) < 1e-300:
                if p[dim] < lo or p[dim] > hi:
                    return None
                continue
            ta = (lo - p[dim]) / d[dim]
            tb = (hi - p[dim]) / d[dim]
            if ta > tb:
                ta, tb = tb, ta
            t0, t1 = max(t0, ta), min(t1, tb)
            if t0 > t1:
                return None
        return t0, t1

    for i in range(len(pts) - 1):
        p, q = pts[i], pts[i + 1]
        res = clip_seg(p, q)
        if res is None:
            if len(cur) >= 2:
                out.append(np.asarray(cur))
            cur = []
            continue
        t0, t1 = res
        a = p + t0 * (q - p) if t0 > 0 else p
        b = p + t1 * (q - p) if t1 < 1 else q
        if not cur:
            cur = [a]
        elif not np.allclose(cur[-1], a, atol=1e-12):
            if len(cur) >= 2:
                out.append(np.asarray(cur))
            cur = [a]
        cur.append(b)
        if t1 < 1:  # exits the box: close this piece
            if len(cur) >= 2:
                out.append(np.asarray(cur))
            cur = []
    if len(cur) >= 2:
        out.append(np.asarray(cur))
    # drop degenerate pieces
    return [c for c in out if np.linalg.norm(np.diff(c, axis=0), axis=1).sum() > 1e-12]


def clip_polygon_to_box(ring, minx, miny, maxx, maxy):
    """Sutherland-Hodgman polygon ∩ box -> single ring [K, 2] or None.

    Exact for intersections that are a single connected region (always true
    for convex inputs).  A concave polygon whose box intersection is
    DISCONNECTED comes back as one self-touching ring whose pieces are joined
    by doubled zero-width bridge edges along the box boundary; the NumPy
    union_polygons cancels those bridges (both sides equally covered), and
    the shapely delegation repairs them via buffer(0)."""
    poly = [np.asarray(p, dtype=np.float64) for p in np.asarray(ring, dtype=np.float64)]

    def clip_edge(poly, axis, value, keep_less):
        if not poly:
            return []
        out = []
        n = len(poly)
        for i in range(n):
            cur, nxt = poly[i], poly[(i + 1) % n]
            cin = (cur[axis] <= value) if keep_less else (cur[axis] >= value)
            nin = (nxt[axis] <= value) if keep_less else (nxt[axis] >= value)
            if cin:
                out.append(cur)
            if cin != nin:
                t = (value - cur[axis]) / (nxt[axis] - cur[axis])
                out.append(cur + t * (nxt - cur))
        return out

    poly = clip_edge(poly, 0, maxx, True)
    poly = clip_edge(poly, 0, minx, False)
    poly = clip_edge(poly, 1, maxy, True)
    poly = clip_edge(poly, 1, miny, False)
    if len(poly) < 3:
        return None
    ring = np.asarray(poly)
    if abs(signed_area(ring)) < 1e-12:
        return None
    return ring


def _dedupe_ring(ring):
    """Remove consecutive duplicate vertices (incl. wraparound)."""
    ring = np.asarray(ring, dtype=np.float64)
    keep = np.ones(len(ring), bool)
    keep[1:] = np.linalg.norm(ring[1:] - ring[:-1], axis=1) > 1e-12
    ring = ring[keep]
    if len(ring) > 1 and np.linalg.norm(ring[0] - ring[-1]) < 1e-12:
        ring = ring[:-1]
    return ring


def _points_in_ring(pts, ring):
    """Even-odd test, vectorized over pts [M, 2] against one ring -> bool [M]."""
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x0, y0 = ring[:, 0][None, :], ring[:, 1][None, :]
    x1 = np.roll(ring[:, 0], -1)[None, :]
    y1 = np.roll(ring[:, 1], -1)[None, :]
    cond = (y0 <= y) != (y1 <= y)
    with np.errstate(all="ignore"):
        xi = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    return (np.sum(cond & (x < xi), axis=1) % 2).astype(bool)


def _covered(pts, polys):
    """bool [M]: point inside >=1 polygon (even-odd exterior minus holes)."""
    out = np.zeros(len(pts), bool)
    for ext, holes in polys:
        inside = _points_in_ring(pts, ext)
        for h in holes:
            inside &= ~_points_in_ring(pts, h)
        out |= inside
    return out


def union_polygons(polygons, snap=1e-6, eps=5e-5):
    """Exact union of arbitrary — possibly partially-overlapping — polygons.

    Replaces shapely.ops.unary_union (reference:
    dataset/nuscenes2clip.py:155-190,299-345) via a planar arrangement:

      1. snap all ring vertices to a `snap` grid; collect every edge
      2. build a vertex pool = ring vertices + all pairwise proper edge
         intersections; split every edge at every pool vertex lying on it
         (handles crossings, T-junctions, and collinear overlaps uniformly)
      3. classify each unique sub-edge by sampling coverage `eps` off each
         side of its midpoint: it is union boundary iff exactly one side is
         covered by >=1 input polygon; orient it interior-on-left
      4. face-trace loops (next edge = first clockwise from the reversed
         incoming direction), yielding CCW exteriors and CW holes

    polygons: list of (exterior_ring [N, 2], [hole_rings...]).
    Returns list of (exterior_ring CCW, [hole_rings CW]).

    When shapely is importable the union delegates to it (bit-level parity
    with the reference); the arrangement below is the self-contained path.
    """
    if HAVE_SHAPELY:
        return shapely_backend().union_polygons(polygons)
    from collections import defaultdict

    polys, seg_list = [], []
    for ext, holes in polygons:
        ext = _dedupe_ring(np.round(np.asarray(ext, np.float64) / snap) * snap)
        if len(ext) < 3:
            continue
        hs = []
        for h in holes:
            h = _dedupe_ring(np.round(np.asarray(h, np.float64) / snap) * snap)
            if len(h) >= 3:
                hs.append(h)
        polys.append((ext, hs))
        for ring in [ext] + hs:
            seg_list.append(np.stack([ring, np.roll(ring, -1, axis=0)], axis=1))
    if not polys:
        return []
    segs = np.concatenate(seg_list, axis=0)  # [E, 2, 2]
    p0, p1 = segs[:, 0], segs[:, 1]
    d = p1 - p0
    n_seg = len(segs)
    if n_seg > 4000:
        import warnings

        # the face-tracing stage is a per-sub-edge Python loop (~O(E^2)-ish):
        # make a minutes-long shapely-free union diagnosable, not mysterious
        warnings.warn(
            f"union_polygons fallback on {n_seg} edges without shapely — "
            "this pure-NumPy planar arrangement may take minutes; install "
            "shapely for the fast path", RuntimeWarning, stacklevel=2)

    # vertex pool: ring vertices + pairwise proper intersections (chunked to
    # bound the [E, E] broadcast memory)
    pool = [p0]
    for lo in range(0, n_seg, 512):
        hi = min(lo + 512, n_seg)
        w = p0[None, :] - p0[lo:hi, None]  # [B, E, 2] = p0_j - p0_i
        denom = d[lo:hi, None, 0] * d[None, :, 1] - d[lo:hi, None, 1] * d[None, :, 0]
        with np.errstate(all="ignore"):
            ti = (w[..., 0] * d[None, :, 1] - w[..., 1] * d[None, :, 0]) / denom
            tj = (w[..., 0] * d[lo:hi, None, 1] - w[..., 1] * d[lo:hi, None, 0]) / denom
        ok = (
            (np.abs(denom) > 1e-12)
            & (ti > -1e-12) & (ti < 1 + 1e-12)
            & (tj > -1e-12) & (tj < 1 + 1e-12)
        )
        if ok.any():
            ii, jj = np.nonzero(ok)
            pool.append(p0[lo + ii] + ti[ii, jj, None] * d[lo + ii])
    pool = np.concatenate(pool, axis=0)
    pool = np.unique(np.round(pool / snap), axis=0) * snap

    def key(p):
        return (int(round(p[0] / snap)), int(round(p[1] / snap)))

    # split segments at pool vertices lying on them
    tol2 = (2.0 * snap) ** 2
    sub = {}  # unordered key pair -> (a, b) representative
    for i in range(n_seg):
        L2 = float(d[i] @ d[i])
        if L2 < tol2:
            continue
        t = ((pool - p0[i]) @ d[i]) / L2
        on = (t > 1e-9) & (t < 1 - 1e-9)
        chain = [p0[i], p1[i]]
        if on.any():
            proj = p0[i] + t[on, None] * d[i]
            hit = np.sum((pool[on] - proj) ** 2, axis=1) < tol2
            if hit.any():
                pts, ts = pool[on][hit], t[on][hit]
                chain = [p0[i]] + list(pts[np.argsort(ts)]) + [p1[i]]
        for a, b in zip(chain[:-1], chain[1:]):
            ka, kb = key(a), key(b)
            if ka == kb:
                continue
            sub.setdefault((min(ka, kb), max(ka, kb)), (np.asarray(a), np.asarray(b)))

    if not sub:
        return []
    A = np.stack([v[0] for v in sub.values()])
    B = np.stack([v[1] for v in sub.values()])
    mid = 0.5 * (A + B)
    tang = B - A
    nrm = np.stack([-tang[:, 1], tang[:, 0]], axis=1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    left_cov = _covered(mid + eps * nrm, polys)
    right_cov = _covered(mid - eps * nrm, polys)

    # boundary edges, oriented interior-on-left
    adj = defaultdict(list)  # node key -> [[angle, end_key, a_pt, b_pt], ...]
    for idx in np.nonzero(left_cov != right_cov)[0]:
        a, b = (A[idx], B[idx]) if left_cov[idx] else (B[idx], A[idx])
        ang = float(np.arctan2(b[1] - a[1], b[0] - a[0]))
        adj[key(a)].append([ang, key(b), a, b, False])

    # face-trace: at each node continue with the outgoing edge first
    # clockwise from the reversed incoming direction
    def next_edge(node_key, rev_angle):
        best, best_delta = None, None
        for rec in adj.get(node_key, ()):
            if rec[4]:
                continue
            delta = (rev_angle - rec[0]) % (2 * np.pi)
            if delta <= 1e-12:
                delta = 2 * np.pi
            if best is None or delta < best_delta:
                best, best_delta = rec, delta
        return best

    loops = []
    for start_key in list(adj.keys()):
        for rec in adj[start_key]:
            if rec[4]:
                continue
            rec[4] = True
            loop = [rec[2]]
            cur_key, cur_pt = rec[1], rec[3]
            in_ang = rec[0]
            guard = 0
            while cur_key != start_key and guard < 10_000_000:
                loop.append(cur_pt)
                nxt = next_edge(cur_key, (in_ang + np.pi) % (2 * np.pi))
                if nxt is None:
                    loop = None  # open chain: numerically degenerate, drop
                    break
                nxt[4] = True
                cur_key, cur_pt, in_ang = nxt[1], nxt[3], nxt[0]
                guard += 1
            if loop is not None and len(loop) >= 3:
                loops.append(np.asarray(loop))

    exteriors = [lp for lp in loops if is_ccw(lp)]
    holes = [lp for lp in loops if not is_ccw(lp)]

    # each hole belongs to the smallest exterior containing it (unions can
    # nest: island exteriors sit inside another polygon's hole)
    out = [(ext, []) for ext in exteriors]
    for h in holes:
        probe = _interior_probe(h)
        containing = [
            (abs(signed_area(ext)), slot)
            for slot, (ext, _) in enumerate(out)
            if _point_in_ring(probe, ext)
        ]
        if containing:
            out[min(containing)[1]][1].append(h)
    return out


def _interior_probe(ring, eps=1e-5):
    """A point strictly inside the ring polygon — edge midpoints nudged along
    both normals, falling back to the first vertex.  A bare ring vertex can
    sit exactly ON a containing exterior at a pinch vertex, making the
    even-odd test knife-edged."""
    ring = np.asarray(ring, dtype=np.float64)
    n = len(ring)
    for i in range(min(n, 8)):
        a, b = ring[i], ring[(i + 1) % n]
        mid = 0.5 * (a + b)
        d = b - a
        L = np.hypot(d[0], d[1])
        if L < 1e-12:
            continue
        nrm = np.array([-d[1], d[0]]) / L
        for sgn in (1.0, -1.0):
            p = mid + sgn * eps * nrm
            if _point_in_ring(p, ring):
                return p
    return ring[0]


def union_tiling_polygons(polygons):
    """Deprecated name kept for older callers; now the general union."""
    return union_polygons(polygons)


def shapely_backend():
    """Reference-parity geometry ops backed by shapely, when importable.

    Returns a namespace with `union_polygons(polygons)` (shapely
    unary_union, same signature/return as the NumPy one) and
    `linemerge(lines)`.  Raises ImportError when shapely is absent — callers
    should fall back to the module-level NumPy implementations.
    """
    if not HAVE_SHAPELY:
        raise ImportError("shapely is not installed")
    from types import SimpleNamespace

    from shapely.geometry import MultiPolygon, Polygon, LineString
    from shapely.ops import linemerge as shp_linemerge, unary_union

    def _union(polygons):
        # buffer(0) repairs self-touching rings (e.g. the bridged output of
        # clip_polygon_to_box on disconnected concave intersections), which
        # unary_union would otherwise reject with a TopologyException
        shp = []
        for ext, holes in polygons:
            p = Polygon(ext, holes)
            if not p.is_valid:
                p = p.buffer(0)
            if not p.is_empty:
                shp.append(p)
        u = unary_union(shp)
        geoms = list(u.geoms) if isinstance(u, MultiPolygon) else [u]
        out = []
        for g in geoms:
            if g.is_empty:
                continue
            ext = np.asarray(g.exterior.coords)[:-1]
            if not is_ccw(ext):
                ext = ext[::-1]
            hs = []
            for hole in g.interiors:
                h = np.asarray(hole.coords)[:-1]
                if is_ccw(h):
                    h = h[::-1]
                hs.append(h)
            out.append((ext, hs))
        return out

    def _linemerge(lines):
        merged = shp_linemerge([LineString(l) for l in lines])
        geoms = getattr(merged, "geoms", [merged])
        return [np.asarray(g.coords) for g in geoms]

    return SimpleNamespace(union_polygons=_union, linemerge=_linemerge)


def _point_in_ring(pt, ring):
    x, y = pt
    ring = np.asarray(ring)
    x0, y0 = ring[:, 0], ring[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    cond = (y0 <= y) != (y1 <= y)
    with np.errstate(all="ignore"):
        xi = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    return int(np.sum(cond & (x < xi))) % 2 == 1


def linemerge(lines):
    """Greedy merge of polylines sharing endpoints (shapely.ops.linemerge-ish).

    Endpoint-indexed: each round picks, for the smallest i with any match,
    the smallest j > i sharing an endpoint — the same (i, j) a plain
    pairwise scan chooses, at O(1) candidate lookup instead of O(n) per i."""
    lines = [np.asarray(l, dtype=np.float64) for l in lines if len(l) >= 2]

    def key(p):
        return (round(float(p[0]) * 1e9), round(float(p[1]) * 1e9))

    merged = True
    while merged and len(lines) > 1:
        merged = False
        by_start, by_end = {}, {}
        for j, l in enumerate(lines):
            by_start.setdefault(key(l[0]), []).append(j)
            by_end.setdefault(key(l[-1]), []).append(j)
        for i in range(len(lines)):
            a = lines[i]
            ka0, ka1 = key(a[0]), key(a[-1])
            cands = [
                j
                for bucket in (by_start.get(ka1, ()), by_end.get(ka1, ()),
                               by_end.get(ka0, ()), by_start.get(ka0, ()))
                for j in bucket
                if j > i
            ]
            if not cands:
                continue
            j = min(cands)
            b = lines[j]
            # case order matches the pairwise scan: a-end to b-start first
            if ka1 == key(b[0]):
                lines[i] = np.concatenate([a, b[1:]])
            elif ka1 == key(b[-1]):
                lines[i] = np.concatenate([a, b[::-1][1:]])
            elif ka0 == key(b[-1]):
                lines[i] = np.concatenate([b, a[1:]])
            else:
                lines[i] = np.concatenate([b[::-1], a[1:]])
            lines.pop(j)
            merged = True
            break
    return lines
