"""What the benchmark reads from the program while it runs, without
changing it: every PhaseTimers the program creates during the window (the
pipelines' and evaluators' phase clocks), and every frame handed to a
VideoSink (counted per sink and pass; a seeded sample of them copied for
the output check).  With tracing on, each timed phase, each frame handed
to an encoder and each encoder's close is also a host span, an interval of
perf_counter kept in a list (no profiler is involved), so the trace can say
what the host was doing while the card sat idle.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter

import numpy as np


class Taps:
    def __init__(self, trace=False):
        self.trace = trace
        self.recording = False
        self.spans = []
        self.timers = []
        self.expected = {}
        self._pass = 0
        self._written = Counter()
        self._gap = 0
        self._plan = {}
        self._slots = []
        self._seen = 0
        self._cap = 0
        self._rng = None

    def span(self, name):
        if not (self.trace and self.recording):
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name):
        """Keeps (start us, end us, name) of the block by perf_counter."""
        a = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((a / 1e3, time.perf_counter_ns() / 1e3, name))

    def install(self):
        """Put the tapping subclasses where the program looks its classes
        up."""
        import cama_tpu_torch.pipeline as pipeline
        import cama_tpu_torch.profiling as profiling

        taps = self
        base_timers, base_sink = profiling.PhaseTimers, pipeline.VideoSink

        class TapTimers(base_timers):
            def __init__(self):
                super().__init__()
                if taps.recording:
                    taps.timers.append(self)

            @contextlib.contextmanager
            def phase(self, name):
                with taps.span(name), super().phase(name):
                    yield

        class TapSink(base_sink):
            def add_frame(self, image_bgr):
                with taps.span("video_sink.add_frame"):
                    taps.on_frame(self.output_path, image_bgr)
                    super().add_frame(image_bgr)

            def close(self):
                with taps.span("video_sink.close"):
                    super().close()

        self._originals = (base_timers, base_sink)
        profiling.PhaseTimers = pipeline.PhaseTimers = TapTimers
        pipeline.VideoSink = TapSink

    def uninstall(self):
        import cama_tpu_torch.pipeline as pipeline
        import cama_tpu_torch.profiling as profiling

        profiling.PhaseTimers = pipeline.PhaseTimers = self._originals[0]
        pipeline.VideoSink = self._originals[1]

    def timer_totals(self):
        """{phase: seconds} summed over the timers created in the window."""
        out = Counter()
        for t in self.timers:
            for name, sec in t.total.items():
                out[name] += sec
        return dict(out)

    # ---------------- video frames ----------------

    def expect_sinks(self, expected, capacity, seed):
        """Sinks by output path and the frames each pass writes to each;
        `capacity` frames of the window are kept, a reservoir sample drawn
        from `seed`."""
        self.expected = dict(expected)
        self._cap = int(capacity)
        self._rng = np.random.default_rng([int(seed), 7])

    def start_window(self):
        self.recording = True
        self.timers = []
        self.spans = []
        self._gap, self._plan, self._slots, self._seen = 0, {}, [], 0

    def stop_window(self):
        self.recording = False

    def begin_pass(self):
        """Opens the next pass and returns its number (1 for the first pass
        of the process, set-up's included)."""
        self._pass += 1
        self._written = Counter()
        if not (self.recording and self._cap):
            return self._pass
        for path in sorted(self.expected):
            key = (self._pass, path)
            k = int(self._rng.integers(self.expected[path]))
            self._seen += 1
            if len(self._slots) < self._cap:
                slot = len(self._slots)
                self._slots.append(None)
            else:
                slot = int(self._rng.integers(self._seen))
                if slot >= self._cap:
                    continue
                self._plan = {kk: v for kk, v in self._plan.items() if v[1] != slot}
                self._slots[slot] = None
            self._plan[key] = (k, slot)
        return self._pass

    def on_frame(self, path, image):
        k = self._written[path]
        self._written[path] += 1
        want = self._plan.get((self._pass, path))
        if self.recording and want is not None and want[0] == k:
            self._slots[want[1]] = ((path, k, self._pass), np.array(image, copy=True))

    def end_pass(self):
        if self.recording:
            for path, n in self.expected.items():
                self._gap = max(self._gap, abs(self._written[path] - n))
            for path in self._written:
                if path not in self.expected:
                    self._gap = max(self._gap, self._written[path])
        return sum(self._written.values())

    def frames_gap(self):
        return self._gap

    def samples(self):
        """[((sink path, frame number in its video, pass), frame)] kept;
        two passes may give the same frame, and each is checked."""
        return [s for s in self._slots if s is not None]
