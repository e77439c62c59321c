"""The port's bit-exact lane against the JAX package on CPU, all with
tolerance 0: the double-f32 arithmetic (_two_sum, _two_prod, _df_dot4,
_df_div, _df_frac_dist) on seeded inputs, project_frame_exact and
rasterize_exact_host, the compensated half of project_frames_checked, its
ambiguity flags (equal wherever the two packages' f32 keep bits and pixel
floors agree, and sound against the float64 chain).  The lane built on
them, iter_overlay_rasters_exact, is held in tests/test_torch_exact_lane.py.
JAX runs eagerly, as project_frames_checked does on CPU when its jit probe
fails."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.ops import geometry as jg
from cama_tpu.ops import raster as jr
from cama_tpu_torch.ops import geometry as tg
from cama_tpu_torch.ops import raster as tr
from cama_tpu_torch.pipeline import ClipPipeline


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test suite runs several worker processes at once; one intra-op
    torch thread in this one keeps torch's CPU ops from oversubscribing the
    cores (the compared results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the input triple that exposed a compiler's rewrite of the error-free
# transforms (cama_tpu/ops/geometry.py:_eft_jit_faithful)
PROBE_ROW = np.array([[612.9723510742188, -664.3383178710938,
                       -0.1483260989189148, 5025.9521484375],
                      [1.0, 2.0, 3.0, 4.0],
                      [0.1, 0.2, 0.3, 0.4]], np.float32)
PROBE_P4 = np.array([-257.9800109863281, -243.37962341308594,
                     0.07289975136518478, 1.0], np.float32)


def _f32(rng, shape, scale):
    """Seeded float32 values over several magnitudes, both signs."""
    return (rng.normal(size=shape) * scale
            * 10.0 ** rng.integers(-3, 3, size=shape)).astype(np.float32)


def _eq(t_out, j_out):
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", ["_two_sum", "_two_prod"])
def test_error_free_transforms_match_jax_and_are_exact(name):
    rng = np.random.default_rng(11)
    a, b = _f32(rng, (3, 4096), 50.0), _f32(rng, (3, 4096), 7.0)
    out = getattr(tg, name)(torch.from_numpy(a), torch.from_numpy(b))
    _eq(out, getattr(jg, name)(jnp.asarray(a), jnp.asarray(b)))
    # error-free: value + error is the float64 result exactly
    want = (a.astype(np.float64) + b if name == "_two_sum"
            else a.astype(np.float64) * b)
    got = out[0].numpy().astype(np.float64) + out[1].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_lo", [False, True])
def test_df_dot4_matches_jax(with_lo):
    rng = np.random.default_rng(12)
    row = _f32(rng, (6, 3, 1, 4), 300.0)
    p4 = _f32(rng, (1, 1, 2048, 4), 100.0)
    p4[..., 3] = 1.0
    lo = (_f32(rng, (6, 3, 1, 4), 300.0) * 2.0 ** -25) if with_lo else None
    t_out = tg._df_dot4(torch.from_numpy(row), torch.from_numpy(p4),
                        row_lo=None if lo is None else torch.from_numpy(lo))
    j_out = jg._df_dot4(jnp.asarray(row), jnp.asarray(p4),
                        row_lo=None if lo is None else jnp.asarray(lo))
    _eq(t_out, j_out)


def test_df_dot4_probe_is_compensated():
    """s + e of the probe triple within 1e-7 relative of the float64 sum."""
    s, e = tg._df_dot4(torch.from_numpy(PROBE_ROW), torch.from_numpy(PROBE_P4))
    want = float(np.sum(PROBE_ROW[0].astype(np.float64)
                        * PROBE_P4.astype(np.float64)))
    got = float(s[0]) + float(e[0])
    assert abs(got - want) < 1e-7 * abs(want), (got, want)
    _eq((s, e), jg._df_dot4(jnp.asarray(PROBE_ROW), jnp.asarray(PROBE_P4)))


def test_df_div_and_frac_dist_match_jax():
    rng = np.random.default_rng(13)
    n = 8192
    xs, zs = _f32(rng, n, 900.0), np.abs(_f32(rng, n, 20.0)) + 1e-3
    xe = (xs * 2.0 ** -26 * rng.normal(size=n)).astype(np.float32)
    ze = (zs * 2.0 ** -26 * rng.normal(size=n)).astype(np.float32)
    t_in = [torch.from_numpy(a) for a in (xs, xe, zs, ze)]
    j_in = [jnp.asarray(a) for a in (xs, xe, zs, ze)]
    q_t, q_j = tg._df_div(*t_in), jg._df_div(*j_in)
    _eq(q_t, q_j)
    # values on and next to integer lines, where the second word decides
    q1 = np.concatenate([q_t[0].numpy(), np.arange(-4, 60, dtype=np.float32)])
    q2 = np.concatenate([q_t[1].numpy(),
                         np.tile(np.float32([-1e-6, 0.0, 1e-6, 3e-5]), 16)])
    _eq(tg._df_frac_dist(torch.from_numpy(q1), torch.from_numpy(q2)),
        jg._df_frac_dist(jnp.asarray(q1), jnp.asarray(q2)))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_fixture_clip(tmp_path_factory.mktemp("texact"), n_frames=6)


@pytest.fixture(scope="module")
def pipe(clip):
    return ClipPipeline(clip_path=clip, chunk=4, device="cpu",
                        raster_kernel="compact")


def _sources(p):
    return [s for s in ("cama", "nuscenes") if s in p.scene.flat]


def _checked_inputs(p, source):
    """numpy (points, valid, A, B, B_lo, fv) padded to the chunk, B_lo as
    iter_overlay_rasters_exact takes it, held against the JAX lane's."""
    from cama_tpu.parallel.sharding import pad_to_multiple

    fm, A, B, fv, F = p._chunked_AB(source)
    fp = p.scene.flat[source]
    B_lo = p.exact_B_lo(source)
    # the JAX package's residual (cama_tpu/pipeline.py:1197-1198)
    B64 = pad_to_multiple(fm.B, p.chunk)
    np.testing.assert_array_equal(
        B_lo, (B64 - B.astype(np.float64)).astype(np.float32))
    return fm, fp, A, B, B_lo, fv, F


def test_project_frame_exact_byte_identical(pipe):
    for source in _sources(pipe):
        fm = pipe.frame_matrices(source)
        fp = pipe.scene.flat[source]
        h, w = pipe.scene.output_size
        for pts in (fp.points, fp.points.astype(np.float64)):
            args = (pts, np.linalg.inv(fm.chassis2world_f32[1]),
                    pipe.scene.chassis2cam, pipe.scene.K_scaled, w, h)
            kept = 0
            for (vu_t, keep_t), (vu_j, keep_j) in zip(
                    tg.project_frame_exact(*args),
                    jg.project_frame_exact(*args)):
                assert vu_t.dtype == vu_j.dtype == np.float64
                np.testing.assert_array_equal(vu_t, vu_j)
                np.testing.assert_array_equal(keep_t, keep_j)
                kept += int(keep_t.sum())
            assert kept > 0


def test_rasterize_exact_host_and_composite_byte_identical():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
    names = ["lane_marking", "Road_teeth", "Crosswalk_Line"]
    vu_list = [(names[i % 3], rng.uniform(-4, 70, size=(40, 2)))
               for i in range(7)]
    np.testing.assert_array_equal(
        tr.rasterize_exact_host(img, vu_list, names),
        jr.rasterize_exact_host(img, vu_list, names))
    packed = rng.integers(-1, 40, size=(48, 64)).astype(np.int32)
    table = tr.build_color_table(names)
    table = np.concatenate([table] * 3)[:tr.MAX_CLS]
    np.testing.assert_array_equal(
        tr.composite_overlay_host(img, packed, table),
        jr.composite_overlay_host(img, packed, table))


def test_checked_compensated_half_bit_identical(pipe):
    """cs, ce, ps, pe, u1, u2, v1, v2 of every frame against the JAX op
    sequence (cama_tpu/ops/geometry.py:_checked_frame) run eagerly."""
    for source in _sources(pipe):
        fm, fp, A, B, B_lo, fv, F = _checked_inputs(pipe, source)
        p4 = np.concatenate([fp.points, np.ones_like(fp.points[:, :1])], -1)
        for f in range(F):
            cs, ce, ps, pe, z_ok, u1, u2, v1, v2 = tg._compensated_frame(
                *(torch.from_numpy(a) for a in (p4, A[f], B[f], B_lo[f])))
            jp4, Af, Bf, Bl = (jnp.asarray(a)
                               for a in (p4, A[f], B[f], B_lo[f]))
            jcs, jce = jg._df_dot4(Af[:3, None, :], jp4[None, :, :])
            jps, jpe = jg._df_dot4(Bf[:, :, None, :], jp4[None, None, :, :],
                                   row_lo=Bl[:, :, None, :])
            zs, ze = jps[:, 2], jpe[:, 2]
            jz_ok = jnp.abs(zs + ze) > jnp.float32(jg.AMBIGUITY_BAND_M)
            zs_safe = jnp.where(jz_ok, zs, 1.0)
            ze_safe = jnp.where(jz_ok, ze, 0.0)
            ju = jg._df_div(jps[:, 0], jpe[:, 0], zs_safe, ze_safe)
            jv = jg._df_div(jps[:, 1], jpe[:, 1], zs_safe, ze_safe)
            _eq((cs, ce, ps, pe, z_ok, u1, u2, v1, v2),
                (jcs, jce, jps, jpe, jz_ok, *ju, *jv))


def test_checked_flags_match_jax_where_f32_agrees(pipe):
    """The production f32 values are each package's own (einsum there, the
    port's elementwise order here), so amb is held equal on every point
    whose f32 keep bits and pixel floors agree in all cameras; vu and keep
    are the port's project_frames, bit for bit."""
    assert tg.AMBIGUITY_BAND_PX == jg.AMBIGUITY_BAND_PX
    assert tg.AMBIGUITY_BAND_M == jg.AMBIGUITY_BAND_M
    h, w = pipe.scene.output_size
    for source in _sources(pipe):
        fm, fp, A, B, B_lo, fv, F = _checked_inputs(pipe, source)
        tin = [torch.from_numpy(np.ascontiguousarray(a))
               for a in (fp.points, fp.valid, A, B, B_lo, fv)]
        vu, keep, amb = tg.project_frames_checked(
            *tin, w, h, pipe._crop_lo, pipe._crop_hi)
        vu0, keep0 = tg.project_frames(tin[0], tin[1], tin[2], tin[3], tin[5],
                                       w, h, pipe._crop_lo, pipe._crop_hi)
        assert torch.equal(vu, vu0) and torch.equal(keep, keep0)
        outs = [jg._checked_frame(
            jnp.asarray(fp.points), jnp.asarray(fp.valid), jnp.asarray(A[f]),
            jnp.asarray(B[f]), jnp.asarray(B_lo[f]), jnp.asarray(fv[f]), w, h,
            pipe._crop_lo, pipe._crop_hi) for f in range(len(fv))]
        jvu = np.stack([np.asarray(o[0]) for o in outs])
        jkeep = np.stack([np.asarray(o[1]) for o in outs])
        jamb = np.stack([np.asarray(o[2]) for o in outs])
        either = keep.numpy() | jkeep
        same = ((keep.numpy() == jkeep)
                & (~either | (np.floor(vu.numpy()) == np.floor(jvu)).all(-1))
                ).all(axis=1)
        assert same.mean() > 0.999
        np.testing.assert_array_equal(amb.numpy()[same], jamb[same])
        assert amb.numpy()[same].any()
        assert not amb.numpy()[~fv].any()


def test_checked_flags_cover_every_f64_disagreement(pipe):
    """Soundness of the error model on the port: any per-point disagreement
    between the f32 projection and the exact f64 chain (keep flip, or
    pixel-floor flip among kept points) carries the ambiguity flag, and the
    flag set stays a small superset."""
    h, w = pipe.scene.output_size
    for source in _sources(pipe):
        fm, fp, A, B, B_lo, fv, F = _checked_inputs(pipe, source)
        vu, keep, amb = (x.numpy() for x in tg.project_frames_checked(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (fp.points, fp.valid, A, B, B_lo, fv)),
            w, h, pipe._crop_lo, pipe._crop_hi))
        n_amb = n_pts = 0
        for f in range(F):
            if not fm.frame_valid[f]:
                continue
            cam_outs = tg.project_frame_exact(
                fp.points, np.linalg.inv(fm.chassis2world_f32[f]),
                pipe.scene.chassis2cam, pipe.scene.K_scaled, w, h)
            for c, (vu_e, keep_e) in enumerate(cam_outs):
                keep_e = keep_e & fp.valid
                flip = keep[f, c] != keep_e
                both = keep[f, c] & keep_e
                with np.errstate(invalid="ignore"):
                    qdev = vu[f, c].astype(np.int32)
                    qex = np.nan_to_num(vu_e).astype(np.int32)
                pixflip = both & np.any(qdev != qex, axis=-1)
                bad = (flip | pixflip) & ~amb[f]
                assert not bad.any(), (
                    f"{source} frame {f} cam {c}: "
                    f"{int(bad.sum())} unflagged f32/f64 disagreements")
            n_amb += int(amb[f].sum())
            n_pts += int(fp.valid.sum())
        assert n_amb < 0.05 * n_pts, (n_amb, n_pts)
