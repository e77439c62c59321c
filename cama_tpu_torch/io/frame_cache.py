"""The per-clip store of undistorted frames: cama_tpu/io/frame_cache.py,
reused as is (loaded by cama_tpu_torch.io.host_module, without jax)."""
from cama_tpu_torch.io import host_module

_frame_cache = host_module("frame_cache")
FrameCache = _frame_cache.FrameCache
frame_cache_key = _frame_cache.frame_cache_key
