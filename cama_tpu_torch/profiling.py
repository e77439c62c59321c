"""Tracing and profiling: per-phase wall-clock timers (cama_tpu/profiling.py's
PhaseTimers and GLOBAL_TIMERS) and a device trace on torch.profiler, the
counterpart of the JAX package's jax.profiler trace."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimers:
    """Named wall-clock accumulators with counts; thread-safe enough for the
    pipeline's coarse phases."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def add(self, name, seconds, n=1):
        self.total[name] += seconds
        self.count[name] += n

    def fps(self, name):
        """Calls per second of phase `name` (nan before its first call)."""
        return self.count[name] / self.total[name] if self.total[name] else float("nan")

    def report(self):
        """One line per phase: seconds, count, ms per call, calls per
        second."""
        lines = []
        for name in sorted(self.total):
            t, n = self.total[name], self.count[name]
            lines.append(
                f"{name:<28} {t:8.3f}s  n={n:<6} {1000 * t / max(n, 1):8.2f} ms/it"
                f"  {n / t if t else float('nan'):8.1f} it/s"
            )
        return "\n".join(lines)

    def as_dict(self):
        return {
            name: {"seconds": self.total[name], "count": self.count[name]}
            for name in self.total
        }


# CUDA runtime and driver calls whose work shows as a device event with
# the call's correlation id
_DEVICE_CALLS = ("LaunchKernel", "Memset", "Memcpy")


def untraced_launches(trace_path):
    """(calls, lost): in a Chrome trace written by torch.profiler, the CUDA
    runtime and driver calls that launch a kernel, memset or copy, and how
    many of them have no device event of the same correlation id."""
    import json

    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    calls, seen = set(), set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr is None:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            if any(k in e.get("name", "") for k in _DEVICE_CALLS):
                calls.add(corr)
        elif e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
            seen.add(corr)
    return len(calls), len(calls - seen)


@contextlib.contextmanager
def device_trace(log_dir, device="cuda"):
    """torch.profiler trace of the enclosed block: host (CPU) activity, and
    the card's kernels and copies when `device` is a CUDA device.  Writes
    one Chrome trace (trace_<pid>_<ns>.json, for chrome://tracing or
    Perfetto) into log_dir and yields the profiler.  The card is
    synchronized before the trace closes, so the block's kernels are in it.
    'cuda' without a card raises; nothing is written when the block
    raises.

    torch.profiler can lose the card's events: on an H100 host, traces
    held some of the kernels launched in them once the process was ~30 s
    old and none from ~50 s on, while a fresh process traced them all
    (tools/profiler_loss.py measures it).  So a CUDA trace is checked
    when written: a launch, memset or copy call whose device event is
    missing (untraced_launches) raises a RuntimeWarning that says how many
    are missing.  Trace from a fresh process when it does."""
    import os
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cama_tpu_torch.pipeline import resolve_device

    on_card = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(str(log_dir),
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if on_card:
        calls, lost = untraced_launches(path)
        if lost:
            warnings.warn(f"{path}: {lost} of the {calls} kernel, memset and "
                          f"copy launches traced have no device event: "
                          f"torch.profiler lost them; trace from a fresh "
                          f"process", RuntimeWarning, stacklevel=3)


GLOBAL_TIMERS = PhaseTimers()
