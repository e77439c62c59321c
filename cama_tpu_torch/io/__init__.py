"""Host I/O of the port: clip reader, scene compiler, fixture clip, frame
cache and video sink, each a jax-free copy of its cama_tpu/io module."""
