"""Tracing and profiling: per-phase wall-clock timers (cama_tpu/profiling.py's
PhaseTimers), the program's spans, and a device trace on torch.profiler, the
counterpart of the JAX package's jax.profiler trace, with the spans written
into it on the trace's clock."""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict

# the open SpanLog, or None: PhaseTimers.phase records spans only while one
# is open (device_trace opens one)
_SPAN_LOG = None
# spans a SpanLog keeps (~50 frames/s x 6 phases a frame x 10 min); the
# rest are counted as dropped
SPAN_LOG_CAPACITY = 1 << 18


class SpanLog:
    """The spans of every PhaseTimers phase closed while the log is open:
    (start s, end s, name, thread id, span id, parent span id) by
    perf_counter, the parent being the phase open on the same thread (0
    when none is), across PhaseTimers instances.  At most
    SPAN_LOG_CAPACITY spans are kept; `dropped` counts the rest."""

    def __init__(self):
        self.capacity = SPAN_LOG_CAPACITY
        self.spans = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def open(self):
        """(span id, parent id, thread id) of a span starting on this
        thread.  The thread's id is asked of the system once a thread (a
        system call, which has cost ~10 us a call on an H100 host)."""
        local = self._local
        stack = getattr(local, "ids", None)
        if stack is None:
            stack = local.ids = []
            local.tid = threading.get_native_id()
        sid = next(self._ids)
        parent = stack[-1] if stack else 0
        stack.append(sid)
        return sid, parent, local.tid

    def close(self, name, t0, t1, sid, parent, tid):
        stack = getattr(self._local, "ids", [])
        if stack and stack[-1] == sid:
            stack.pop()
        elif sid in stack:  # closed out of order (an abandoned generator)
            stack.remove(sid)
        if len(self.spans) < self.capacity:
            self.spans.append((t0, t1, name, tid, sid, parent))
        else:
            with self._lock:
                self.dropped += 1


@contextlib.contextmanager
def span_log():
    """Open a SpanLog for the enclosed block and yield it; the log that was
    open before is restored after."""
    global _SPAN_LOG
    log, before = SpanLog(), _SPAN_LOG
    _SPAN_LOG = log
    try:
        yield log
    finally:
        _SPAN_LOG = before


class PhaseTimers:
    """Named wall-clock accumulators with counts; thread-safe enough for the
    pipeline's coarse phases.  While a span log is open (span_log,
    device_trace), each phase is also a span of it, on the accumulator's
    own two clock readings."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        log = _SPAN_LOG
        t0 = time.perf_counter()
        if log is None:
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0
                self.count[name] += 1
            return
        ids = log.open()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.total[name] += t1 - t0
            self.count[name] += 1
            log.close(name, t0, t1, *ids)

    def add(self, name, seconds, n=1):
        """Adds to a phase without timing it; a counter is add(name, 0.0)."""
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


# CUDA runtime and driver calls whose work shows as a device event with
# the call's correlation id
_DEVICE_CALLS = ("LaunchKernel", "Memset", "Memcpy")
# the host's mark of the trace's clock: a cudaDeviceSynchronize on a card, a
# record_function of this name on the CPU
_SYNC_CALL = "cudaDeviceSynchronize"
_CLOCK_MARK = "cama_tpu_torch.clock_mark"


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


def _clock_mark(on_card):
    """(a, b): the perf_counter readings, in us, around one event the trace
    records: a card synchronisation, or on the CPU a record_function (whose
    first call in a process pays a lazy set-up: device_trace makes one
    before the trace opens)."""
    import torch

    a = time.perf_counter() * 1e6
    if on_card:
        torch.cuda.synchronize()
    else:
        with torch.profiler.record_function(_CLOCK_MARK):
            pass
    return a, time.perf_counter() * 1e6


def _write_spans(path, log, marks, on_card, host_tid):
    """Add the log's spans to the Chrome trace at `path`, on the trace's
    clock, as complete events on their thread's track (args: id, parent),
    and the trace-level key "cama_spans": {spans, dropped, clock_drift_us}.
    The host clock + offset = the trace's, from the opening mark: the
    middle of the marking event in the trace against the middle of the
    host's readings around it (the host's overhead before and after the
    call cancel); `marks` are the readings of a first opening mark, the one
    used and the closing one, and the drift is the closing mark's distance
    from the offset.  The spans of thread `host_tid`, the one that made
    the marks, go on the marking events' track (a card's trace names a
    thread by CUPTI's id, not the system's).  Returns the "cama_spans"
    dict."""
    import json
    import os

    with open(path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    if on_card:
        marked = [e for e in events if e.get("cat") == "cuda_runtime"
                  and e.get("name") == _SYNC_CALL]
    else:
        marked = [e for e in events if e.get("name") == _CLOCK_MARK]
    if len(marked) < 3:
        raise RuntimeError(f"{path}: the trace holds no opening and closing "
                           f"clock marks")

    def nearest(mark, offset):
        """The marking event nearest where the host put `mark`
        (torch.profiler adds a synchronisation of its own as it stops)."""
        return min(marked, key=lambda e: abs(float(e["ts"]) - offset - mark[0]))

    def middle(e):
        return float(e["ts"]) + float(e.get("dur", 0.0)) / 2

    # the first mark pays the profiler's lazy set-up inside the host's
    # readings around it (~0.9 ms on an H100 host), so it serves only to
    # find the second
    first = min(float(e["ts"]) for e in marked)
    opening = nearest(marks[1], first - marks[0][0])
    offset = middle(opening) - sum(marks[1]) / 2
    drift = middle(nearest(marks[2], offset)) - offset - sum(marks[2]) / 2
    pid = opening.get("pid", os.getpid())
    tid = opening.get("tid", host_tid)
    for t0, t1, name, span_tid, sid, parent in log.spans:
        events.append({"ph": "X", "cat": "cama_span", "name": name,
                       "pid": pid, "tid": tid if span_tid == host_tid
                       else span_tid, "ts": t0 * 1e6 + offset,
                       "dur": (t1 - t0) * 1e6,
                       "args": {"id": sid, "parent": parent}})
    info = {"spans": len(log.spans), "dropped": log.dropped,
            "clock_drift_us": drift}
    trace["cama_spans"] = info
    with open(path, "w") as f:
        json.dump(trace, f)
    return info


@contextlib.contextmanager
def device_trace(log_dir, device="cuda", cpu_ops=False):
    """torch.profiler trace of the enclosed block, with the program's own
    spans (every PhaseTimers phase closed in the block, span_log) on the
    trace's clock.  On a CUDA device it records the card's kernels, memsets
    and copies and the CUDA calls that launch them; `cpu_ops=True` adds
    the CPU operators, which slow the host and so inflate the phases it
    times.  On the CPU it records the CPU operators.  Writes one Chrome
    trace (trace_<pid>_<ns>.json, for chrome://tracing or Perfetto) into
    log_dir and yields the profiler.  The card is synchronized at the
    block's start and end: the block's kernels are in the trace, and the
    cudaDeviceSynchronize events tie perf_counter to the trace's clock
    (record_function marks do on the CPU; _write_spans).  The spans are complete
    events, category "cama_span", on their thread's track, with args
    {id, parent}; the trace's top-level "cama_spans" holds their count, the
    spans dropped past the log's capacity and the clock drift at the close
    in us, and so does the profiler's attribute `cama_spans` once the block
    has closed (with `trace_path`, the file written).  'cuda' without a
    card raises; nothing is written when the block raises.

    torch.profiler can lose the card's events: on an H100 host, traces
    held some of the kernels launched in them once the process was ~30 s
    old and none from ~50 s on, while a fresh process traced them all
    (tools/profiler_loss.py measures it).  So a CUDA trace is checked
    when written: a launch, memset or copy call whose device event is
    missing (untraced_launches) raises a RuntimeWarning that says how many
    are missing.  Trace from a fresh process when it does."""
    import os
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from cama_tpu_torch.pipeline import resolve_device

    on_card = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] if cpu_ops or not on_card else []
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    if not on_card:
        _clock_mark(False)
    with span_log() as log:
        with profile(activities=activities) as prof:
            marks = [_clock_mark(on_card), _clock_mark(on_card)]
            yield prof
            marks.append(_clock_mark(on_card))
    path = os.path.join(str(log_dir),
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    info = prof.cama_spans = _write_spans(path, log, marks, on_card,
                                          threading.get_native_id())
    prof.trace_path = path
    if info["dropped"]:
        warnings.warn(f"{path}: {info['dropped']} spans dropped past the "
                      f"span log's capacity of {log.capacity}",
                      RuntimeWarning, stacklevel=3)
    if on_card:
        calls, lost = untraced_launches(path)
        if lost:
            warnings.warn(f"{path}: {lost} of the {calls} kernel, memset and "
                          f"copy launches traced have no device event: "
                          f"torch.profiler lost them; trace from a fresh "
                          f"process", RuntimeWarning, stacklevel=3)
