"""cama_tpu_torch's all-camera projection (ops/geometry.py project_frames,
ops/pallas_project.py) against the JAX package's project_frames and its
Pallas kernel (interpret mode on CPU, as tests/test_pallas_project.py runs
it) on identical numpy inputs, plus the CUDA kernel against its plain
version on the card (marked `cuda`, skipped without one)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cama_tpu.io.fixture import make_fixture_clip
from cama_tpu.ops import geometry as jgeo
from cama_tpu.ops.pallas_project import project_frame_pallas as j_pallas
from cama_tpu_torch.io.scene import compile_scene
from cama_tpu_torch.ops import pallas_project as tpp
from cama_tpu_torch.ops.geometry import (compose_frame_matrices, crop_bounds,
                                         project_frames)

# both packages project in float32, each ~0.006 px from the float64 truth
# on this fixture and rounding differently (FMA chain vs elementwise order;
# measured max |port - jax| 0.0059 px), so (v, u) are compared at the f32
# noise scale tests/test_pallas_project.py uses for the same two paths
VU_TOL_PX = 2e-2
IMG_BORDER_PX = 1e-3  # keep bits may differ this close to an image bound
CROP_BORDER_M = 1e-4  # ... or this close to a crop-box bound


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(points, valid, A, B, fv, w, h, lo, hi) of the fixture's cama source
    as numpy arrays."""
    clip = make_fixture_clip(tmp_path_factory.mktemp("tpp"), n_frames=4,
                             with_images=False, with_lidar=False)
    scene = compile_scene(clip)
    fm = compose_frame_matrices(scene.traj["cama"], scene.frame_times,
                                scene.chassis2cam, scene.K_scaled)
    fp = scene.flat["cama"]
    h, w = scene.output_size
    lo, hi = crop_bounds()
    return (fp.points, fp.valid, fm.A.astype(np.float32),
            fm.B.astype(np.float32), fm.frame_valid, w, h, lo, hi)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_projection(name, points, valid, A, B, fv, w, h, lo, hi):
    """(vu [F, C, P, 2], keep [F, C, P]) from the named JAX function."""
    if name == "project_frames":
        vu, keep = jgeo.project_frames(
            jnp.asarray(points), jnp.asarray(valid), jnp.asarray(A),
            jnp.asarray(B), jnp.asarray(fv), w, h, jnp.asarray(lo),
            jnp.asarray(hi))
        return np.asarray(vu), np.asarray(keep)
    p4T = jnp.asarray(np.concatenate(
        [points, np.ones((len(points), 1), np.float32)], axis=1).T)
    vus, keeps = [], []
    for f in range(len(fv)):  # the JAX 'pallas' lane masks keep by fv
        vu, keep = j_pallas(p4T, jnp.asarray(valid), jnp.asarray(A[f]),
                            jnp.asarray(B[f]), w, h, jnp.asarray(lo),
                            jnp.asarray(hi), interpret=True)
        vus.append(np.asarray(vu))
        keeps.append(np.asarray(keep) & fv[f])
    return np.stack(vus), np.stack(keeps)


def _near_a_bound(points, A, B, w, h, lo, hi):
    """[F, C, P] bool: points whose float64 projection lies within
    IMG_BORDER_PX of an image bound or CROP_BORDER_M of a crop bound — the
    documented class where f32 dot and elementwise keep bits may differ."""
    p4 = np.concatenate([points.astype(np.float64),
                         np.ones((len(points), 1))], axis=1)
    xyz = np.einsum("fij,pj->fpi", A[:, :3].astype(np.float64), p4)
    crop = ((np.abs(xyz - lo) < CROP_BORDER_M)
            | (np.abs(xyz - hi) < CROP_BORDER_M)).any(-1)
    proj = np.einsum("fcij,pj->fcpi", B.astype(np.float64), p4)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = proj[..., 0] / proj[..., 2]
        v = proj[..., 1] / proj[..., 2]
    img = ((np.abs(u) < IMG_BORDER_PX) | (np.abs(u - w) < IMG_BORDER_PX)
           | (np.abs(v) < IMG_BORDER_PX) | (np.abs(v - h) < IMG_BORDER_PX))
    return img | crop[:, None, :]


@pytest.mark.parametrize("jax_fn", ["project_frames", "project_frame_pallas"])
def test_projection_matches_jax(frames, jax_fn):
    """The port's projection (the wrapper on CPU tensors, which is the plain
    version) against each JAX projection: (v, u) within VU_TOL_PX wherever
    both keep the point, keep bits equal outside the border class."""
    points, valid, A, B, fv, w, h, lo, hi = frames
    args = _t(points, valid, A, B, fv)
    vu_t, keep_t = tpp.project_frame_pallas(*args, w, h, lo, hi)
    vu_r, keep_r = project_frames(*args, w, h, lo, hi)
    assert torch.equal(vu_t, vu_r) and torch.equal(keep_t, keep_r)
    vu_t, keep_t = vu_t.numpy(), keep_t.numpy()
    vu_j, keep_j = _jax_projection(jax_fn, *frames)
    assert vu_t.shape == vu_j.shape and keep_t.shape == keep_j.shape
    both = keep_t & keep_j
    assert both.sum() > 1000, "too few kept points — test is vacuous"
    assert np.abs(vu_t - vu_j)[both].max() <= VU_TOL_PX
    differ = keep_t != keep_j
    near = _near_a_bound(points, A, B, w, h, lo, hi)
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    assert differ.sum() <= 1e-4 * keep_j.sum()
    assert not keep_t[~fv].any()


def test_wrapper_runs_plain_version_only_on_cpu(frames):
    """CPU tensors take the plain version with no launch counted; a device
    without an implementation and malformed inputs raise."""
    points, valid, A, B, fv, w, h, lo, hi = frames
    args = _t(points, valid, A, B, fv)
    tpp.reset_launches()
    tpp.project_frame_pallas(*args, w, h, lo, hi)
    assert tpp.LAUNCHES == {"project_frame_pallas": 0}
    with pytest.raises(ValueError, match="no project_frame_pallas implementation"):
        tpp.project_frame_pallas(*[t.to("meta") for t in args], w, h, lo, hi)
    with pytest.raises(ValueError, match="cameras"):
        tpp.project_frame_pallas(*args[:3], torch.zeros(len(fv), 9, 3, 4),
                                 args[4], w, h, lo, hi)
    with pytest.raises(ValueError, match="valid"):
        tpp.project_frame_pallas(args[0], args[1].to(torch.uint8), *args[2:],
                                 w, h, lo, hi)


def _ragged_case():
    """Identity geometry over a point count that is no multiple of the
    kernel's block (256) or the TPU tile (2048); a quarter of the points
    fall outside the image, some are invalid, and one frame is invalid."""
    rng = np.random.default_rng(11)
    P = 2048 + 256 + 37
    pts = np.stack([rng.uniform(-16, 80, P), rng.uniform(-16, 80, P),
                    rng.uniform(0.5, 2.0, P)], axis=1).astype(np.float32)
    valid = rng.uniform(size=P) > 0.05
    B = np.zeros((2, 2, 3, 4), np.float32)
    B[:, :, 0, 0] = B[:, :, 1, 1] = B[:, :, 2, 2] = 1.0
    B[:, 1, 0, 3] = 3.25  # camera 1 shifted right
    A = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    fv = np.array([True, False])
    return (pts, valid, A, B, fv, 64, 48, np.full(3, -1e6, np.float32),
            np.full(3, 1e6, np.float32))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(frames):
    """On the card: the CUDA kernel equals its plain version bit for bit
    (every vu and keep entry, kept or not) on the fixture and a ragged
    point count, and counts one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_*.py -m cuda)")
    for case in (frames, _ragged_case()):
        points, valid, A, B, fv, w, h, lo, hi = case
        args = [t.cuda() for t in _t(points, valid, A, B, fv)]
        before = tpp.LAUNCHES["project_frame_pallas"]
        vu_k, keep_k = tpp.project_frame_pallas(*args, w, h, lo, hi)
        assert tpp.LAUNCHES["project_frame_pallas"] == before + 1
        vu_r, keep_r = tpp.project_frame_pallas_ref(*args, w, h, lo, hi)
        torch.cuda.synchronize()
        assert keep_r.any()
        assert torch.equal(keep_k, keep_r) and torch.equal(vu_k, vu_r)
