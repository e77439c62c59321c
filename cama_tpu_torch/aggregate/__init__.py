"""LiDAR aggregation and CAMAv2 site aggregation (the port of
cama_tpu/aggregate): lidar.py, site.py."""
from cama_tpu_torch.aggregate.lidar import (
    aggregate_lidar,
    save_pcd,
    save_xyz,
    voxel_downsample,
)
from cama_tpu_torch.aggregate.site import Site, estimate_sim3_to_world

__all__ = [
    "aggregate_lidar",
    "save_pcd",
    "save_xyz",
    "voxel_downsample",
    "Site",
    "estimate_sim3_to_world",
]
