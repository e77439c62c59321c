from cama_tpu_torch.parallel.sharding import (
    make_mesh,
    make_scene_mesh,
    pad_to_multiple,
    sharded_map_metrics,
    sharded_multi_scene_step,
    sharded_overlay_step,
    sharded_scene_batch_metrics,
)

__all__ = [
    "make_mesh",
    "make_scene_mesh",
    "pad_to_multiple",
    "sharded_map_metrics",
    "sharded_multi_scene_step",
    "sharded_overlay_step",
    "sharded_scene_batch_metrics",
]
