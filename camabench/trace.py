"""The device trace of a `--trace 1` run's window: torch.profiler with CUDA
activity only (no CPU operators, no record_function spans, so the host runs
at its untraced pace and the program's phase clocks read as in an untraced
run), from the window's start to its end, reduced to

  busy_s      seconds in which a kernel, memset or copy ran on the card
              (the union of their intervals)
  window_s    the traced window: from the device synchronisation that
              opens it to the one that closes it
  lost        launch, memset and copy calls whose device event the trace
              lacks (torch.profiler has been seen to drop them); a trace
              with any is not used
  device_ops  [[name, seconds]] of the ten device operations that took
              the most time
  idle_gaps   [[host span, seconds]]: the card's idle time, each gap
              charged to the innermost host span (Taps.span: the
              benchmark's own and the program's timed phases, taken by
              the host's clock) open at its middle ("other" when none is)

The host's clock and the trace's are tied by the two synchronisations:
each is a cudaDeviceSynchronize call in the trace and an interval of
perf_counter on the host.
"""
from __future__ import annotations

import heapq
import json
import os
import time
from collections import defaultdict

_DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
_LAUNCH_CALLS = ("LaunchKernel", "Memset", "Memcpy")
_SYNC_CALL = "cudaDeviceSynchronize"


def _now_us():
    return time.perf_counter_ns() / 1e3


class Tracer:
    def __init__(self, out_dir):
        self.path = os.path.join(out_dir, "trace.json")
        self._prof = None
        self.marks = []

    def _mark(self):
        import torch

        a = _now_us()
        torch.cuda.synchronize()
        self.marks.append((a, _now_us()))

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark()

    def stop(self, host_spans):
        """The trace's summary; host_spans [(start us, end us, name)] by
        perf_counter."""
        self._mark()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(self.path)
        return reduce_trace(events, self.marks, host_spans)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events, marks, host_spans):
    """The summary of a trace's events (chrome trace dicts); `marks` are
    the host intervals [(a, b)] of the opening and closing
    synchronisations, `host_spans` [(a, b, name)] on the same clock."""
    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name") == _SYNC_CALL)
    if len(syncs) < 2:
        raise RuntimeError("the trace holds no opening and closing synchronisation")
    w0, w1 = syncs[0][0], syncs[-1][1]
    # host clock + offset = trace clock, from the opening synchronisation
    offset = syncs[0][0] - marks[0][0]
    calls, seen = set(), set()
    device, by_name = [], defaultdict(float)
    for e in events:
        cat = e.get("cat")
        corr = e.get("args", {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            if any(k in e.get("name", "") for k in _LAUNCH_CALLS):
                calls.add(corr)
        elif cat in _DEVICE_CATS:
            if corr is not None:
                seen.add(corr)
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
            if b > a:
                device.append((a, b))
                by_name[e.get("name", cat)] += (b - a) / 1e6
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # the innermost span at each gap's middle: the open span that started
    # last, with spans that ended before the middle dropped as the sweep
    # passes them
    spans = sorted((a + offset, b + offset, name) for a, b, name in host_spans)
    idle = defaultdict(float)
    heap, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        idle[heap[0][2] if heap else "other"] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # the closing synchronisation by both clocks: how far they drifted apart
    drift_us = (syncs[-1][0] - marks[-1][0]) - offset
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6, "lost": len(calls - seen),
            "launches": len(calls), "clock_drift_us": drift_us,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
