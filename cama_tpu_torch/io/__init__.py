"""Host I/O of the port: clip reader, scene compiler, fixture clip, and the
JAX package's frame cache and video sink.

`host_module` loads one of cama_tpu's own jax-free host files straight from
its path.  Importing it as cama_tpu.io.<name> would first run
cama_tpu/io/__init__.py, which imports the clip reader, whose SE(3) module
imports jax whenever jax is installed.
"""
from __future__ import annotations

import importlib.util
import os
import sys


def host_module(name):
    """cama_tpu/io/<name>.py as the module cama_tpu_torch.io._host_<name>,
    loaded once; the file must import nothing of cama_tpu."""
    mod_name = f"{__name__}._host_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    pkg = importlib.util.find_spec("cama_tpu")
    path = os.path.join(os.path.dirname(pkg.origin), "io", f"{name}.py")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod
