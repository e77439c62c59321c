"""Streaming video output (reference: cama/tools.py:12-40); a copy of
cama_tpu/io/video.py.

Backend order: ffmpeg subprocess raw-BGR pipe (reference-identical encoding
settings: 10 fps, yuv420p, libx264) -> cv2.VideoWriter -> raw .npy frame dir.
The environment may lack ffmpeg entirely, so every backend is feature-gated.
"""
from __future__ import annotations

import contextlib
import os
import queue
import shutil
import subprocess
import threading
import time

import numpy as np

CAMERA_GRID = [
    ["camera_front_left", "camera_front", "camera_front_right"],
    ["camera_rear_left", "camera_rear", "camera_rear_right"],
]


def concat_camera_grid(image_dict, out=None):
    """3x2 camera mosaic (cama/tools.py:22-25).

    Implemented as slot assignments into one preallocated buffer:
    np.concatenate measures ~250 ms for this 9.3 MB mosaic on the throttled
    bench host vs ~2 ms for slot fills.  Pass `out` to reuse the buffer
    across frames."""
    h, w = next(iter(image_dict.values())).shape[:2]
    if out is None or out.shape != (h * 2, w * 3, 3):
        out = np.empty((h * 2, w * 3, 3), np.uint8)
    for r, row in enumerate(CAMERA_GRID):
        for c, cam in enumerate(row):
            out[r * h:(r + 1) * h, c * w:(c + 1) * w] = image_dict[cam]
    return out


class VideoSink:
    def __init__(self, output_path, output_shape=(2880, 1080), fps=10,
                 preset=None, async_write=None, timers=None):
        """preset: optional libx264 preset (e.g. 'ultrafast', 'veryfast').
        None keeps the encoder's default — byte-parity with the reference's
        settings (cama/tools.py:13-17). x264 at 2880x1080 dominates video
        writing on a 1-core host, so 'ultrafast' is a ~3-5x knob when output
        bitrate parity does not matter (config key: video_preset).

        async_write: feed frames to the backend from a dedicated thread so
        host compositing of frame n+1 overlaps the encoder's work on frame n
        (ffmpeg is a separate process — on a multi-core host the 9.3 MB pipe
        write otherwise serializes the producer behind x264, the default
        64 KB pipe buffer covers <1 % of a mosaic frame).  Default: on when
        the host has more than one core (overlap is impossible on one core
        and the extra frame copy is pure cost there).  Frame order and
        output bytes are identical either way (tests/test_video_sink.py).

        timers: a profiling.PhaseTimers that times the sink's phases
        (none when None): 'sink_open' (the backend's open, and the counter
        'sink_backend.<ffmpeg|cv2|raw>'), 'sink_wait' (the producer blocked
        on a free buffer: the encoder's back-pressure), 'sink_copy' (the
        producer's copy of a frame or the mosaic concat), 'sink_close' (the
        drain of the last frames and the backend's release) and
        'sink_encode' (the backend's own busy time, n = frames encoded).
        On the async path the feeder thread only accumulates 'sink_encode',
        and close() hands the total to `timers` on the caller's thread, so
        no timer is written from two threads; on the synchronous path the
        write is timed as 'sink_encode' alone."""
        self._timers = timers
        self._closed = False
        self._encode_s = 0.0  # the feeder's busy time and frames, handed
        self._encode_n = 0    # to timers by close()
        self.output_path = str(output_path)
        self.output_shape = tuple(output_shape)  # (w, h)
        self.fps = fps
        self.preset = preset
        self._proc = None
        self._writer = None
        self._frames_dir = None
        self._write_count = 0  # raw-backend file numbering (feeder-thread safe)
        with self._phase("sink_open"):
            self.backend = self._open()
        if timers is not None:
            timers.add(f"sink_backend.{self.backend}", 0.0)
        if async_write is None:
            async_write = (os.cpu_count() or 1) > 1
        self._queue = None
        self._feeder = None
        self._feeder_error = None  # pending exception, surfaced exactly once
        self._failed = False  # latched: feeder stops writing after an error
        if async_write:
            # two in-flight slots + recycled buffers: the producer never
            # waits for the encoder unless it is >2 frames ahead, and no
            # per-frame 9.3 MB allocation happens in steady state
            self._queue = queue.Queue(maxsize=2)
            self._free = queue.Queue()
            for _ in range(3):
                self._free.put(None)  # lazily sized on first frame
            self._feeder = threading.Thread(target=self._feed, daemon=True)
            self._feeder.start()

    def _feed(self):
        while True:
            buf = self._queue.get()
            if buf is None:
                return
            try:
                if not self._failed:
                    t0 = time.perf_counter()
                    self._write_frame(buf)
                    self._encode_s += time.perf_counter() - t0
                    self._encode_n += 1
            except Exception as e:  # surfaced on the caller's thread
                self._failed = True
                self._feeder_error = e
            finally:
                self._free.put(buf)

    def _phase(self, name):
        if self._timers is None:
            return contextlib.nullcontext()
        return self._timers.phase(name)

    def _open(self):
        w, h = self.output_shape
        if shutil.which("ffmpeg"):
            preset_args = ["-preset", self.preset] if self.preset else []
            self._proc = subprocess.Popen(
                [
                    "ffmpeg", "-y", "-loglevel", "quiet",
                    "-f", "rawvideo", "-pix_fmt", "bgr24", "-s", f"{w}x{h}",
                    # input framerate must be declared or ffmpeg assumes 25
                    # fps and the output -r resamples away ~60% of the frames
                    "-framerate", str(self.fps),
                    "-i", "pipe:",
                    "-r", str(self.fps), "-pix_fmt", "yuv420p", "-vcodec", "libx264",
                    *preset_args,
                    self.output_path,
                ],
                stdin=subprocess.PIPE,
            )
            return "ffmpeg"
        try:
            import cv2

            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(self.output_path, fourcc, self.fps, (w, h))
            if self._writer.isOpened():
                return "cv2"
            self._writer = None
        except ImportError:
            pass
        self._frames_dir = self.output_path + ".frames"
        os.makedirs(self._frames_dir, exist_ok=True)
        return "raw"

    def add_frame(self, image_bgr):
        # no-copy when already uint8 C-contiguous (astype unconditionally
        # copies and costs ~100 ms for a mosaic frame on the bench host)
        img = np.ascontiguousarray(image_bgr, dtype=np.uint8)
        w, h = self.output_shape
        if img.shape != (h, w, 3):
            # a mismatched frame would silently desynchronize the raw-BGR
            # pipe (ffmpeg reads fixed-size frames) — fail loudly instead
            raise ValueError(
                f"frame shape {img.shape} != sink shape {(h, w, 3)}")
        if self._queue is not None:
            if self._feeder_error is not None:
                err, self._feeder_error = self._feeder_error, None
                raise err
            with self._phase("sink_wait"):
                buf = self._free.get()
            with self._phase("sink_copy"):
                if buf is None:
                    buf = np.empty_like(img)
                # copy BEFORE returning: callers reuse their mosaic buffers
                np.copyto(buf, img)
            self._queue.put(buf)
        else:
            with self._phase("sink_encode"):
                self._write_frame(img)

    def _write_frame(self, img):
        if self._proc is not None:
            # ndarray exposes the buffer protocol: zero-copy write (tobytes
            # would materialize another ~9 MB copy per mosaic frame)
            self._proc.stdin.write(img)
        elif self._writer is not None:
            self._writer.write(img)
        else:
            np.save(os.path.join(self._frames_dir,
                                 f"{self._write_count:06d}.npy"), img)
            self._write_count += 1

    def add_frame_from_dict(self, image_dict):
        # reuse one mosaic buffer across frames — safe because add_frame
        # either writes before returning or (async feeder) copies eagerly
        with self._phase("sink_copy"):
            self._mosaic = concat_camera_grid(
                image_dict, out=getattr(self, "_mosaic", None))
        self.add_frame(self._mosaic)

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            with self._phase("sink_close"):
                self._close()
        finally:
            if self._encode_n and self._timers is not None:
                self._timers.add("sink_encode", self._encode_s,
                                 n=self._encode_n)

    def _close(self):
        if self._feeder is not None:
            self._queue.put(None)
            self._feeder.join()
            self._feeder = None
            self._queue = None
            if self._feeder_error is not None:
                err, self._feeder_error = self._feeder_error, None
                # still release the backend below, then surface the failure
                self._close_backend()
                raise err
        self._close_backend()

    def _close_backend(self):
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
            self._proc = None
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # reference parity (cama/tools.py:38-40)
        try:
            self.close()
        except Exception:
            pass
