"""The host mosaic compositor: cama_tpu.native (C++, built with g++ at first
use, NumPy fallback without a compiler), reused as is; it imports no jax."""
from cama_tpu.native import available, composite, composite_packed2  # noqa: F401
