"""SE(3) pose algebra, trajectory codecs and the pose-sequence container,
host NumPy float64: the port's copy of cama_tpu/se3 (core.py, codec.py,
trajectory.py), which imports jax whenever it is installed."""
from cama_tpu_torch.se3.codec import (
    asl_to_transforms,
    kitti_to_transforms,
    load_trajectory_txt,
    transforms_to_tum,
    tum_to_transforms,
)
from cama_tpu_torch.se3.core import (
    abs_to_rel,
    as_euler,
    from_euler,
    inv_se3,
    matrix_to_quat,
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_slerp,
    quat_to_matrix,
    quat_to_rotvec,
    rel_to_abs,
    rotvec_to_quat,
    slerp_transform,
)
from cama_tpu_torch.se3.trajectory import (
    Trajectory,
    apply_seek,
    seek_by_timestamps,
    seek_indices,
)

__all__ = [
    "inv_se3", "quat_normalize", "quat_to_matrix", "matrix_to_quat",
    "quat_multiply", "quat_conjugate", "quat_slerp", "rotvec_to_quat",
    "quat_to_rotvec", "slerp_transform", "from_euler", "as_euler",
    "rel_to_abs", "abs_to_rel", "tum_to_transforms", "transforms_to_tum",
    "kitti_to_transforms", "asl_to_transforms", "load_trajectory_txt",
    "Trajectory", "seek_by_timestamps", "seek_indices", "apply_seek",
]
