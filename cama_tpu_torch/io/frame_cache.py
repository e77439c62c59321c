"""Pre-undistorted frame cache: decode + remap each (frame, camera) JPEG
ONCE per clip, then serve raw uint8 pixels from an mmap-able store.

A copy of cama_tpu/io/frame_cache.py, with two repairs of its own: slot
writes loop until os.pwrite has taken every byte, and each write descriptor
is closed exactly once.  Pixels written here are the
byte-exact output of cv2.imread + cv2.remap with the production remap
grids, so serving them preserves pixel parity with the reference path.  The
on-disk layout and key are the JAX package's, so both packages share one
store per clip (tests/test_torch_host.py).

Layout (under ``{clip}/.cama_tpu/``):
  * ``frames_{h}x{w}.npy``       — np.lib.format memmap [N, C, H, W, 3] uint8
  * ``frames_{h}x{w}.valid.npy`` — memmap [N, C] uint8 (1 = slot populated)
  * ``frames_{h}x{w}.key.json``  — cache key; mismatch invalidates the store

Writes go to disjoint slots, so the pipeline's per-camera thread pool can
populate the cache concurrently.  ``get`` returns a read-only view of the
memmap (zero-copy); callers that paint on the image must copy first (the
pipeline's composite paths already do).  ``read_into`` fills a caller's
buffer with a run of consecutive frames, every camera, in one copy, once
``complete`` found each frame's slots all hits: the GT loader's bulk path,
which looks up no source file (a valid slot of a store keyed by the source
files' signature already proves its file was there).

Population is OPPORTUNISTIC by default: puts enqueue to a bounded writer
thread and are DROPPED when the disk cannot keep up (measured on the bench
host: the store writes at ~43 MB/s while a cold video pass produces
~110 MB/s of pixels — synchronous writes would more than double the cold
run).  A slot whose write was dropped simply misses next time and re-enqueues,
so the cache converges to full over runs without ever slowing one down.  The
valid flag lands after the pixel write, so readers never see torn slots.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import os
import queue
import threading
import time
import weakref

import numpy as np


def _close_fds(fds):
    """Close and forget every descriptor in the list `fds`.  Each is popped
    before it is closed, so whoever gets here second (a reopen, then the
    finalizer) finds nothing left and closes no number twice: by then the
    number may belong to another file."""
    while fds:
        try:
            os.close(fds.pop())
        except OSError:
            pass


def _pwrite_all(fd, buf, offset):
    """os.pwrite until every byte of `buf` has landed: one call may write
    fewer bytes than it was given (a signal, a nearly full disk)."""
    view = memoryview(buf).cast("B")
    done = 0
    while done < len(view):
        n = os.pwrite(fd, view[done:], offset + done)
        if n <= 0:
            raise OSError(f"pwrite wrote {n} bytes")
        done += n


def frame_cache_key(camera_list, output_size, K_orig, d, K_scaled, sync_ms):
    """Everything that changes the cached pixels: camera set, output size,
    the remap-defining calibration, and the frame timestamp tables (a
    re-converted clip with different frames must not be served stale)."""
    h = hashlib.sha256()
    h.update(repr(list(camera_list)).encode())
    h.update(repr(tuple(output_size)).encode())
    for arr in (K_orig, d, K_scaled):
        h.update(np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes())
    for cam in camera_list:
        h.update(np.asarray(sync_ms[cam], np.int64).tobytes())
    return h.hexdigest()


class FrameCache:
    """mmap-backed (frame, camera) -> undistorted uint8 image store."""

    # writer backlog bound, in images (~1.5 MB each at 960x540)
    QUEUE_SLOTS = 48
    # sustained fraction of one core's wall-clock the writer may consume
    # (measured round 4: unthrottled population costs a cold video pass
    # ~40-50% of its throughput on a 1-core host — memcpy + first-touch page
    # faults + GIL churn — while the pass itself is the product; the budget
    # keeps the first visit fast and lets the store converge over runs, the
    # documented opportunistic contract)
    WRITE_BUDGET = 0.3
    # seconds of writer time granted up-front (covers small clips and tests
    # outright) and the accrual cap (idle periods bank at most this much)
    BURST_S, BURST_CAP_S = 1.0, 2.0

    def __init__(self, cache_dir, n_frames, n_cameras, output_size, key,
                 async_writes=True, name="frames", dtype=np.uint8, channels=3,
                 write_budget=None):
        """name/dtype/channels generalize the store beyond RGB frames: the
        GT-mask cache stores remapped lane_ins instance ids as
        name='gt_ids', dtype=uint16, channels=0 (no trailing axis) — the
        same ~55 ms/frame decode+remap host floor applies to metric GT as
        to base images, and the same mmap store removes it."""
        self.dir = str(cache_dir)
        self.key = str(key)
        self.dtype = np.dtype(dtype)
        h, w = output_size
        self.shape = (int(n_frames), int(n_cameras), int(h), int(w)) + (
            (int(channels),) if channels else ())
        base = os.path.join(self.dir, f"{name}_{h}x{w}")
        self._data_path = base + ".npy"
        self._valid_path = base + ".valid.npy"
        self._key_path = base + ".key.json"
        self._data = None
        self._valid = None
        self._data_fd = self._valid_fd = None  # pwrite lane (see _write)
        # the open descriptors of that lane: one list, shared with the one
        # finalizer, so each descriptor is closed exactly once
        self._fds = []
        weakref.finalize(self, _close_fds, self._fds)
        self.writable = True
        self.dropped_writes = 0
        self._async = bool(async_writes)
        self._q = None
        self._writer = None
        # token bucket (seconds of writer wall-clock); budget >= 1 disables
        self._budget = (self.WRITE_BUDGET if write_budget is None
                        else float(write_budget))
        self._tokens = self.BURST_S
        self._t_last = time.perf_counter()
        self._open()
        if self._async:
            # started here, not lazily in put(): the per-camera thread pool
            # calls put concurrently, and a racy lazy start can orphan a
            # freshly-created queue (losing enqueued writes silently)
            self._q = queue.Queue(maxsize=self.QUEUE_SLOTS)
            self._writer = threading.Thread(
                target=self._writer_loop, name="frame-cache-writer", daemon=True)
            self._writer.start()
            # drain the backlog at interpreter exit: without this the last
            # <= QUEUE_SLOTS enqueued writes (the clip's tail frames) are
            # dropped EVERY run and those slots would never converge.  The
            # weakref makes a collected cache a no-op instead of pinning the
            # memmaps alive until exit.
            ref = weakref.ref(self)
            atexit.register(lambda: (lambda c: c.flush() if c else None)(ref()))

    # ---------------- store lifecycle ----------------

    def _open(self):
        os.makedirs(self.dir, exist_ok=True)
        _close_fds(self._fds)
        self._data_fd = self._valid_fd = None
        fresh = True
        if os.path.exists(self._key_path):
            try:
                with open(self._key_path) as f:
                    meta = json.load(f)
                fresh = not (
                    meta.get("key") == self.key
                    and tuple(meta.get("shape", ())) == self.shape
                    and meta.get("dtype", "uint8") == self.dtype.name
                    and os.path.exists(self._data_path)
                    and os.path.exists(self._valid_path)
                )
            except (OSError, ValueError):
                fresh = True
        if fresh:
            # create under temp names, then os.replace: a concurrent process
            # holding the old store keeps a valid (unlinked-inode) mapping —
            # never a truncation SIGBUS — and the key file lands last, so
            # readers only see complete stores.  The zero-filled data file is
            # sparse (open_memmap seeks, it does not write).
            pid = os.getpid()
            tmp_data, tmp_valid = f"{self._data_path}.{pid}", f"{self._valid_path}.{pid}"
            data = np.lib.format.open_memmap(
                tmp_data, mode="w+", dtype=self.dtype, shape=self.shape
            )
            valid = np.lib.format.open_memmap(
                tmp_valid, mode="w+", dtype=np.uint8, shape=self.shape[:2]
            )
            os.replace(tmp_data, self._data_path)
            os.replace(tmp_valid, self._valid_path)
            tmp_key = f"{self._key_path}.{pid}"
            with open(tmp_key, "w") as f:
                json.dump({"key": self.key, "shape": list(self.shape),
                           "dtype": self.dtype.name}, f)
            os.replace(tmp_key, self._key_path)
            self._data, self._valid = data, valid
        else:
            try:
                data = np.lib.format.open_memmap(self._data_path, mode="r+")
                valid = np.lib.format.open_memmap(self._valid_path, mode="r+")
                if (data.dtype != self.dtype or data.shape != self.shape
                        or valid.shape != self.shape[:2]):
                    raise ValueError("frame cache shape/dtype mismatch")
                self._data, self._valid = data, valid
            except Exception:
                # corrupt/truncated store (interrupted copy of the clip dir):
                # self-heal by rebuilding instead of failing the scene on
                # every run (same contract as the scene cache)
                for p in (self._data_path, self._valid_path, self._key_path):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                self._open()

    @classmethod
    def open(cls, cache_dir, n_frames, n_cameras, output_size, key, **kwargs):
        """Build a cache, or return None when the directory is not writable
        (read-only clip mounts degrade to the uncached path, never fail)."""
        try:
            return cls(cache_dir, n_frames, n_cameras, output_size, key,
                       **kwargs)
        except Exception:  # unwritable dir, exotic fs: uncached, never fatal
            return None

    # ---------------- access ----------------

    def get(self, frame_idx, cam_idx):
        """Zero-copy read-only view of a cached image, or None on miss."""
        if not self._valid[frame_idx, cam_idx]:
            return None
        img = self._data[frame_idx, cam_idx]
        img = img.view()
        img.flags.writeable = False
        return img

    def complete(self, frame_idx):
        """True when every camera's slot of the frame is a hit."""
        return bool(self._valid[frame_idx].all())

    def read_into(self, frame0, out):
        """Copy frames frame0 .. frame0 + len(out) - 1, every camera, into
        `out`, an array of shape (n,) + shape[1:] and the store's dtype.
        Those slots are one contiguous range of the memmap, so a run is one
        copy.  The caller checks first that each frame is ``complete``:
        valid flags only go from 0 to 1, so a run found complete stays so,
        and a slot's flag lands after its pixels, so a slot read as valid
        is never torn.

        One slice copy from the memmap was faster than one os.preadv of the
        same bytes on the benchmark's H100 host, whose files lie on 9p (8.98
        against 10.47 ms for 49.8 MB into page-locked memory; PERF.md §6).
        The pwrite lane and the memmap share the page cache."""
        out[...] = self._data[frame0:frame0 + len(out)]

    def put(self, frame_idx, cam_idx, image, own=False):
        """Record a decoded image.  Async mode never blocks: if the writer
        backlog is full (disk slower than the producer) the put is dropped —
        the slot just stays a miss until a later run lands it.

        own=True hands the array over WITHOUT the defensive copy: nobody may
        mutate it afterwards, and put enforces that by marking the array
        read-only (composite paths detect the flag and copy before
        painting).  Saves ~1.5 MB of memcpy per image on the cold path."""
        if not self.writable:
            return
        if own:
            # enforce the handover contract centrally: the producer keeps a
            # reference, so freeze the array here — a later mutation would
            # otherwise bake into the persistent store (or race the async
            # writer) no matter which caller forgot the flag
            image.flags.writeable = False
        if not self._async:
            self._write(frame_idx, cam_idx, image)
            return
        if self._q.full():  # skip the ~1.5 MB copy when the put would drop
            self.dropped_writes += 1
            return
        try:
            # defensive copy (unless owned): the producer may paint on its
            # array before the writer lands it (composite overlays would get
            # baked into the cache); the backlog bound keeps copies to ~70 MB
            self._q.put_nowait((frame_idx, cam_idx,
                                image if own else np.array(image, copy=True)))
        except queue.Full:  # lost the race with another producer thread
            self.dropped_writes += 1

    def _open_write_fds(self):
        """fds for the pwrite lane, opened lazily on the writer thread.

        Slot writes go through os.pwrite into the page cache instead of
        storing through the memmap: a first-touch store into a fresh mmap
        page costs a minor fault + zero-fill PER PAGE, measured 7.6 ms for a
        1.5 MB image on the bench host vs 0.47 ms for one pwrite (16x) —
        with writes that cheap the token budget stops binding and the whole
        store lands in a single cold pass.  Reads keep the zero-copy mmap;
        write()/mmap views of the same file share the page cache on Linux,
        so readers see pwrite data coherently."""
        if self._data_fd is None:
            self._data_fd = os.open(self._data_path, os.O_WRONLY)
            self._fds.append(self._data_fd)
            self._valid_fd = os.open(self._valid_path, os.O_WRONLY)
            self._fds.append(self._valid_fd)
        return self._data_fd, self._valid_fd

    def _write(self, frame_idx, cam_idx, image):
        try:
            if (tuple(np.shape(image)) != self.shape[2:]
                    or not (0 <= int(frame_idx) < self.shape[0])
                    or not (0 <= int(cam_idx) < self.shape[1])):
                # the mmap store raised on mismatched assignment; a raw
                # pwrite would instead silently corrupt adjacent slots
                raise ValueError(
                    f"frame cache put: shape {np.shape(image)} / slot "
                    f"({frame_idx},{cam_idx}) out of contract {self.shape}")
            slot = int(frame_idx) * self.shape[1] + int(cam_idx)
            nbytes = self.dtype.itemsize * int(
                np.prod(self.shape[2:], dtype=np.int64))
            dfd, vfd = self._open_write_fds()
            buf = np.ascontiguousarray(image, self.dtype)
            _pwrite_all(dfd, buf.reshape(-1).view(np.uint8),
                        self._data.offset + slot * nbytes)
            # valid flag lands after the pixels (same fd ordering contract
            # as the old store-through-mmap path: readers never see a torn
            # slot marked valid)
            _pwrite_all(vfd, b"\x01", self._valid.offset + slot)
        except Exception:  # disk full, caller shape/index bug, ...: latch
            # read-only.  Anything escaping here would kill the writer
            # thread, after which flush()/the atexit drain deadlock in
            # Queue.join() — a broken cache must degrade, never hang.
            try:
                self._data[frame_idx, cam_idx] = image  # mmap fallback
                self._valid[frame_idx, cam_idx] = 1
            except Exception:
                self.writable = False

    def _writer_loop(self):
        while True:
            item = self._q.get()
            try:
                if item is not None:
                    if self._grant_tokens():
                        t0 = time.perf_counter()
                        self._write(*item)
                        self._tokens -= time.perf_counter() - t0
                    else:
                        self.dropped_writes += 1
            finally:
                self._q.task_done()
            if item is None:
                return

    def _grant_tokens(self):
        """Token-bucket rate limit on writer wall-clock: refill at `budget`
        seconds per wall second (capped), spend actual write time.  Keeps
        cache population from starving the producing pass on a 1-core host;
        budget >= 1 disables the limit."""
        if self._budget >= 1.0:
            return True
        now = time.perf_counter()
        self._tokens = min(self.BURST_CAP_S,
                           self._tokens + (now - self._t_last) * self._budget)
        self._t_last = now
        return self._tokens > 0

    def hit_rate(self):
        return float(np.asarray(self._valid).mean())

    def flush(self):
        """Drain pending writes and sync the memmaps (blocks on the disk)."""
        if self._q is not None:
            self._q.join()
        try:
            self._data.flush()
            self._valid.flush()
        except (OSError, AttributeError):
            pass
