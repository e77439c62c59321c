"""cama_tpu_torch — the CAMA overlay pipeline on PyTorch and CUDA (NVIDIA
Hopper), beside the JAX package cama_tpu it is held against.

It imports nothing of cama_tpu: the host code it needs is carried as
test-pinned copies (tests/test_torch_host.py), and the device path is its
own:

  se3.py                SE(3) pose algebra and pose seek (NumPy float64)
  profiling.py          per-phase wall-clock timers
  native/               the C++ mosaic compositor (g++, ctypes)
  io/clip.py            clip reader
  io/scene.py           scene compiler, scene cache, scene tensors on the device
  io/fixture.py         synthetic fixture clip
  io/frame_cache.py     per-clip store of undistorted frames
  io/video.py           3x2 camera mosaic and video sink
  config.py             config schema of main.py
  ops/lift.py           2-D label -> 3-D polyline lifting
  ops/geometry.py       frame matrices (host) and project_frames (device)
  ops/raster.py         compaction, scatter-max + plus-stencil dilation
                        rasterizers
  ops/fused_compact.py  fused project + dedup + compact: the CUDA kernel's
                        wrapper, its plain PyTorch version, launch counts
  ops/pallas_project.py the 'pallas' lane's projection kernel's wrapper
  ops/paint.py          the max-paint probe kernel's wrapper
  csrc/*.cu             the hand-written kernels (sm_90a), built by _build.py
  pipeline.py           ClipPipeline: the raster_kernel lanes -> videos
  cli.py                python -m cama_tpu_torch.cli --config config.yaml
  tools/bench_kernels.py  kernel-strategy measurements on the card

This package imports torch and never jax, even where jax is installed.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "ClipPipeline":
        from cama_tpu_torch.pipeline import ClipPipeline

        return ClipPipeline
    raise AttributeError(name)
