"""The 3x2 camera mosaic and the video sink: cama_tpu/io/video.py, reused as
is (loaded by cama_tpu_torch.io.host_module, without jax)."""
from cama_tpu_torch.io import host_module

_video = host_module("video")
CAMERA_GRID = _video.CAMERA_GRID
VideoSink = _video.VideoSink
concat_camera_grid = _video.concat_camera_grid
