"""Per-phase wall-clock timers of the pipeline: cama_tpu/profiling.py's
PhaseTimers, cut to the accumulation the port reads (total and count,
timed phases and added events, and the per-phase report)."""
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
