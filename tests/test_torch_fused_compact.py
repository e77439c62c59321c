"""cama_tpu_torch.ops.fused_compact against the JAX package's Pallas kernel
(interpret mode on CPU, as tests/test_fused_compact.py runs it) on identical
numpy inputs, plus the CUDA kernel against its plain version on the card
(marked `cuda`, skipped without one)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.ops import fused_compact as jfc
from cama_tpu.ops.raster import MAX_CLS, packed_to_cls as j_packed_to_cls
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.ops import fused_compact as tfc
from cama_tpu_torch.ops.geometry import compose_frame_matrices, crop_bounds
from cama_tpu_torch.ops.raster import packed_to_cls
from cama_tpu_torch.tools import fused_cases

_HI = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(points, valid, cls, A, B, fv, w, h, lo, hi) of the fixture's cama
    source as numpy arrays."""
    clip = make_fixture_clip(tmp_path_factory.mktemp("tfc"), n_frames=4,
                             with_images=False, with_lidar=False)
    scene = compile_scene(clip)
    fm = compose_frame_matrices(scene.traj["cama"], scene.frame_times,
                                scene.chassis2cam, scene.K_scaled)
    fp = scene.flat["cama"]
    h, w = scene.output_size
    lo, hi = crop_bounds()
    return (fp.points, fp.valid, fp.cls, fm.A.astype(np.float32),
            fm.B.astype(np.float32), fm.frame_valid, w, h, lo, hi)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_frame(points, valid, cls, A, B, w, h, lo, hi, k_cap):
    """One frame through the Pallas kernel in interpret mode: (live rows
    [min(count, k_cap), C] int32, count)."""
    p4T = jnp.asarray(np.concatenate(
        [points, np.ones((len(points), 1), np.float32)], axis=1).T)
    vals, cnt = jfc.fused_compact_project(
        p4T, jnp.asarray(valid), jnp.asarray(cls), jnp.asarray(A),
        jnp.asarray(B), w, h, jnp.asarray(lo), jnp.asarray(hi), k_cap,
        interpret=True)
    n = int(cnt)
    return np.asarray(vals)[:min(n, k_cap), :B.shape[0]].astype(np.int32), n


def _jax_pixels(points, valid, A, B, w, h, lo, hi):
    """Per-camera pixel codes [C, P] (-1 = not kept) with the JAX kernel's
    arithmetic (XLA dot, HIGHEST), to locate the points whose keep bits or
    pixels differ from the port's elementwise order."""
    P, C = len(points), B.shape[0]
    p4T = jnp.asarray(np.concatenate([points, np.ones((P, 1), np.float32)], 1).T)
    xyz = np.asarray(jax.lax.dot(jnp.asarray(A), p4T, precision=_HI))
    in_crop = ((xyz[:3] >= lo[:, None]) & (xyz[:3] <= hi[:, None])).all(0)
    B4 = np.concatenate([B, np.zeros((C, 1, 4), np.float32)], 1)
    proj = np.asarray(jax.lax.dot(jnp.asarray(B4.reshape(C * 4, 4)), p4T,
                                  precision=_HI)).reshape(C, 4, P)
    z = proj[:, 2]
    safe_z = np.where(z > 0, z, np.float32(1))
    u, v = proj[:, 0] / safe_z, proj[:, 1] / safe_z
    keep = ((z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            & in_crop[None] & valid[None])
    with np.errstate(invalid="ignore"):
        pix = v.astype(np.int32) * w + u.astype(np.int32)
    return np.where(keep, pix, -1)


def _rows_by_point(pix, cls):
    """{point index: union row payload [C]} from pixel codes [C, P]."""
    succ = np.concatenate([pix[:, 1:], np.full_like(pix[:, :1], -1)], 1)
    eff = (pix >= 0) & (succ != pix)
    val = np.where(eff, pix * MAX_CLS + cls[None] + 1, 0)
    idx = np.flatnonzero(eff.any(0))
    return idx, val[:, idx].T


def test_ref_matches_jax_kernel_on_fixture(frames):
    """The plain version against the Pallas kernel, frame by frame.

    The port projects with an elementwise ((m0*x + m1*y) + m2*z) + m3 order
    so that its CUDA kernel and plain version agree exactly on the card;
    XLA's CPU dot evaluates the same rows as a fused multiply-add chain, so
    a few border points can flip a keep bit or a pixel floor between the two
    packages.  Hence the contract checked here: the union list is
    bit-identical on every row whose point (and successor) has the same
    pixel codes in both packages, those differing points are a tiny
    fraction, and the per-frame rasters agree at >= 0.99999 (the repo's
    device-lane contract, VALIDATE.json)."""
    points, valid, cls, A, B, fv, w, h, lo, hi = frames
    k_cap = 8192
    vals_t, cnt_t = tfc.fused_compact_project(*_t(points, valid, cls, A, B, fv),
                                              w, h, lo, hi, k_cap)
    port_pix = [tfc._pixels(*_t(points), torch.from_numpy(valid & fv[f]),
                            *_t(A[f], B[f]), w, h, lo, hi).numpy()
                for f in range(len(fv))]
    C = B.shape[1]
    checked = 0
    for f in np.flatnonzero(fv):
        vals_j, n_j = _jax_frame(points, valid, cls, A[f], B[f], w, h, lo, hi,
                                 k_cap)
        n_t = int(cnt_t[f])
        assert n_j > 0 and n_t <= k_cap and n_j <= k_cap
        jpix = _jax_pixels(points, valid, A[f], B[f], w, h, lo, hi)
        tpix = port_pix[f]
        # the JAX list is exactly what its pixel codes imply
        idx_j, rows_j = _rows_by_point(jpix, cls)
        np.testing.assert_array_equal(vals_j[:n_j], rows_j)
        idx_t, rows_t = _rows_by_point(tpix, cls)
        assert n_t == len(idx_t)
        np.testing.assert_array_equal(vals_t[f, :n_t].numpy(), rows_t)

        differ = (jpix != tpix).any(0)
        assert differ.sum() <= 1e-3 * valid.sum(), differ.sum()
        near = differ | np.concatenate([differ[1:], [False]])
        agree_j = ~near[idx_j]
        agree_t = ~near[idx_t]
        np.testing.assert_array_equal(idx_j[agree_j], idx_t[agree_t])
        np.testing.assert_array_equal(vals_j[:n_j][agree_j],
                                      vals_t[f, :n_t].numpy()[agree_t])

        r_j = np.asarray(j_packed_to_cls(jfc.rasterize_from_union(
            jnp.asarray(np.pad(vals_j, ((0, 0), (0, 8 - C))).astype(np.float32)),
            n_j, C, w, h)))
        r_t = packed_to_cls(tfc.rasterize_from_union(
            vals_t[f], cnt_t[f], w, h)).numpy()
        agree = (r_j == r_t).mean()
        assert agree >= 0.99999, f"frame {f}: agreement {agree}"
        checked += 1
    assert checked >= 2


def _tile_boundary_case():
    """Same-pixel runs (a new pixel every 3 points) straddling every warp,
    block and Pallas-tile boundary, invalid points sprinkled inside runs,
    in an exactly representable identity geometry; adapted from
    tests/test_fused_compact.py."""
    P = jfc.TILE + 512
    rng = np.random.default_rng(3)
    B = np.zeros((1, 1, 3, 4), np.float32)
    B[0, 0, 0, 0] = B[0, 0, 1, 1] = B[0, 0, 2, 2] = 1.0
    A = np.eye(4, dtype=np.float32)[None]
    lo = np.full(3, -1e6, np.float32)
    hi = np.full(3, 1e6, np.float32)
    w = h = 64
    base = np.repeat(np.arange(P // 3 + 2), 3)[:P]
    pts = np.stack([(base % w).astype(np.float32),
                    ((base // w) % h).astype(np.float32),
                    np.ones(P, np.float32)], axis=1)
    valid = np.ones(P, bool)
    valid[rng.choice(P, 200, replace=False)] = False
    cls = (base % 3).astype(np.int32)
    return pts, valid, cls, A, B, np.ones(1, bool), w, h, lo, hi


def test_ref_matches_jax_kernel_across_tile_boundaries():
    """Exact arithmetic in both packages: count and rows bit for bit."""
    pts, valid, cls, A, B, fv, w, h, lo, hi = _tile_boundary_case()
    k_cap = 4096
    vals_t, cnt_t = tfc.fused_compact_project(*_t(pts, valid, cls, A, B, fv),
                                              w, h, lo, hi, k_cap)
    vals_j, n_j = _jax_frame(pts, valid, cls, A[0], B[0], w, h, lo, hi, k_cap)
    assert int(cnt_t[0]) == n_j > 0
    np.testing.assert_array_equal(vals_t[0, :n_j].numpy(), vals_j[:n_j])
    # the plain counting half agrees with the compaction's count
    cnt = tfc.count_union(*_t(pts, valid, cls, A, B, fv), w, h, lo, hi)
    assert int(cnt[0]) == n_j


@pytest.mark.parametrize("frame", [0, 3, 5, 9])
def test_ref_matches_jax_kernel_on_crop_straddling_case(frame):
    """Exact geometry in both packages, crop edges cutting same-pixel runs,
    whole groups outside the crop or behind the cameras next to kept ones,
    P = 31k + 5, two cameras: count and rows bit for bit (frame 5 is
    invalid: no rows)."""
    pts, valid, cls, A, B, fv, w, h, lo, hi = fused_cases.crop_straddle_case(
        16, groups=200)
    k_cap = 8192
    sl = slice(frame, frame + 1)
    vals_t, cnt_t = tfc.fused_compact_project(
        *_t(pts, valid, cls, A[sl], B[sl], fv[sl]), w, h, lo, hi, k_cap)
    n_t = int(cnt_t[0])
    if fv[frame]:
        vals_j, n_j = _jax_frame(pts, valid, cls, A[frame], B[frame], w, h,
                                 lo, hi, k_cap)
    else:
        n_j = 0
    assert n_t == n_j and (n_t > 0) == bool(fv[frame])
    np.testing.assert_array_equal(vals_t[0, :n_t].numpy(),
                                  vals_j[:n_j] if n_j else vals_t[0, :0].numpy())


@pytest.mark.parametrize("case", ["tile_boundary", "crop_straddle"])
def test_count_union_equals_compaction_count(case):
    """The counting entry point agrees with the compaction's count on every
    frame of the edge cases (including an invalid frame)."""
    args = (fused_cases.tile_boundary_case(8192 + 512) if case == "tile_boundary"
            else fused_cases.crop_straddle_case(16, groups=200))
    t = _t(*args[:6])
    _, cnt = tfc.fused_compact_project(*t, *args[6:], 16)
    got = tfc.count_union(*t, *args[6:])
    assert torch.equal(got, cnt) and int(cnt.max()) > 16


def test_overflow_is_reported(frames):
    """count > k_cap is reported with the true total, and the first k_cap
    rows are the first k_cap survivors (the JAX contract)."""
    points, valid, cls, A, B, fv, w, h, lo, hi = frames
    args = _t(points, valid, cls, A, B, fv)
    full, n = tfc.fused_compact_project(*args, w, h, lo, hi, 8192)
    f = int(np.flatnonzero(fv)[0])
    small = int(n[f]) // 2
    assert small > 8
    vals, cnt = tfc.fused_compact_project(*args, w, h, lo, hi, small)
    assert int(cnt[f]) == int(n[f]) > small
    np.testing.assert_array_equal(vals[f].numpy(), full[f, :small].numpy())


def test_rasterize_from_union_matches_jax():
    """Union list -> raster: identical integers to the JAX function,
    including rows past count (ignored) and zero entries (absent)."""
    rng = np.random.default_rng(7)
    w, h, C, K = 48, 32, 3, 300
    vals = np.where(rng.uniform(size=(K, C)) > 0.4,
                    rng.integers(0, w * h, (K, C)) * MAX_CLS
                    + rng.integers(0, 3, (K, C)) + 1, 0).astype(np.int32)
    count = 211
    got = tfc.rasterize_from_union(torch.from_numpy(vals),
                                   torch.tensor(count, dtype=torch.int32),
                                   w, h).numpy()
    vals8 = np.pad(vals, ((0, 0), (0, 8 - C))).astype(np.float32)
    ref = np.asarray(jfc.rasterize_from_union(jnp.asarray(vals8), count, C,
                                              w, h))
    np.testing.assert_array_equal(got, ref)


def test_wrapper_runs_plain_version_only_on_cpu(frames):
    """The wrapper routes CPU tensors to the plain version (no launch
    counted) and refuses a device it has no implementation for."""
    points, valid, cls, A, B, fv, w, h, lo, hi = frames
    tfc.reset_launches()
    args = _t(points, valid, cls, A, B, fv)
    got = tfc.fused_compact_project(*args, w, h, lo, hi, 4096)
    ref = tfc.fused_compact_project_ref(*args, w, h, lo, hi, 4096)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tfc.LAUNCHES == {"fused_compact_project": 0, "count_union": 0}
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no fused_compact implementation"):
        tfc.fused_compact_project(*meta, w, h, lo, hi, 4096)
    with pytest.raises(ValueError, match="cameras"):
        tfc.fused_compact_project(*args[:4], torch.zeros(len(fv), 9, 3, 4),
                                  args[5], w, h, lo, hi, 4096)


def _card_cases(frames):
    """(name, case, k_cap) of the card check: the fixture, the tile
    boundaries, the crop-straddling case at F = 1 and F = 16, and the
    latter again with k_cap at half its largest count (overflow)."""
    one = fused_cases.crop_straddle_case(1)
    many = fused_cases.crop_straddle_case(16)
    return [("fixture", frames, 8192),
            ("tile_boundary", fused_cases.tile_boundary_case(8192 + 512), 8192),
            ("crop_straddle F=1", one, 16384),
            ("crop_straddle F=16", many, 16384),
            ("overflow F=16", many, 4800)]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(frames):
    """On the card: the CUDA kernel equals its plain version exactly (count
    and every live row, up to k_cap) on every edge case, one launch per
    call, and the counting entry point agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_*.py -m cuda)")
    for name, case, k_cap in _card_cases(frames):
        points, valid, cls, A, B, fv, w, h, lo, hi = case
        args = [t.cuda() for t in _t(points, valid, cls, A, B, fv)]
        before = dict(tfc.LAUNCHES)
        vals_k, cnt_k = tfc.fused_compact_project(*args, w, h, lo, hi, k_cap)
        cnt_c = tfc.count_union(*args, w, h, lo, hi)
        assert tfc.LAUNCHES == {k: v + 1 for k, v in before.items()}
        vals_r, cnt_r = tfc.fused_compact_project_ref(*args, w, h, lo, hi,
                                                      k_cap)
        torch.cuda.synchronize()
        assert torch.equal(cnt_k, cnt_r), name
        assert torch.equal(cnt_c, cnt_r), name
        if name.startswith("overflow"):
            assert int(cnt_r.max()) > k_cap
        for f in range(len(fv)):
            n = min(int(cnt_r[f]), k_cap)
            assert torch.equal(vals_k[f, :n], vals_r[f, :n]), (name, f)
