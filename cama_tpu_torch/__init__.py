"""cama_tpu_torch — the CAMA overlay pipeline on PyTorch and CUDA (NVIDIA
Hopper), beside the JAX package cama_tpu it is held against.

It reuses cama_tpu's host modules that import no jax (lifting, profiling
timers, native compositor, and the frame cache and video sink, loaded from
their files by io.host_module), carries test-pinned copies of the host code
whose cama_tpu modules pull jax in, and has its own device path:

  se3.py                SE(3) pose algebra and pose seek (NumPy float64)
  io/clip.py            clip reader
  io/scene.py           scene compiler, scene cache, scene tensors on the device
  io/fixture.py         synthetic fixture clip
  config.py             config schema of main.py
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
