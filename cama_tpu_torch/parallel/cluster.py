"""Local multi-process cluster launcher (the test and smoke face of the
multi-device tier).

Counterpart of cama_tpu/parallel/cluster.py.  parallel/multihost.py is the
in-process side: each process calls `multihost.initialize(...)` and joins
the torch.distributed world as one rank.  This module is the launcher
side for single-machine clusters: spawn N child processes, collect one
JSON payload from each, and clean up deterministically on any failure.
The hazards this handles:

- **Backend chatter**: gloo and NCCL can print to stdout around teardown,
  *after* the child's JSON line.  Parsing blindly takes whatever line is
  last; we take the last line that parses as a JSON object.
- **Hung children leak siblings**: `communicate(timeout=...)` raises
  without killing anything; a wedged rendezvous or a rank that raised
  while the others wait in a collective would strand N-1 live processes.
  Every exit path here kills the whole cluster first.
- **Inherited rendezvous settings**: the parent may itself run under a
  launcher (torchrun) that set MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
  LOCAL_RANK and LOCAL_WORLD_SIZE; each child takes its rank, world and
  device from its argv instead, so those are dropped from its
  environment.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import threading
import time

# Env vars a child rank must pick for itself, not inherit.
_CHILD_ENV_DROP = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                   "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def free_port() -> int:
    """An OS-assigned free TCP port for the torch.distributed store."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _last_json_line(out: str):
    """The last stdout line that is a JSON object, or None.

    Children print exactly one JSON payload; anything after it is backend
    teardown chatter (see module docstring)."""
    for ln in reversed(out.strip().splitlines()):
        ln = ln.strip()
        if ln.startswith("{"):
            try:
                return json.loads(ln)
            except json.JSONDecodeError:
                continue
    return None


def run_local_cluster(cmds, env=None, timeout=240.0):
    """Spawn one process per argv in `cmds`, return their JSON payloads.

    All processes are started before any is waited on (they rendezvous
    with each other through the torch.distributed store, so sequential
    spawn + join would deadlock), and every child's stdout/stderr pipes are
    drained CONCURRENTLY: a sequential communicate() loop would let a
    chatty child fill its ~64 KB pipe buffer and block mid-collective while
    the parent still waits on an earlier rank.  On a timeout or a nonzero
    exit the WHOLE cluster is killed before raising: no stranded siblings.

    env: base environment (default os.environ); the rendezvous variables
    of _CHILD_ENV_DROP are always dropped.
    Returns: list of parsed JSON dicts, one per process, in cmds order.
    """
    child_env = {k: v for k, v in (env or os.environ).items()
                 if k not in _CHILD_ENV_DROP}
    procs = [subprocess.Popen(list(cmd), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=child_env)
             for cmd in cmds]

    results = [None] * len(procs)  # (out, err) per child, set by its reader

    def _drain(i, p):
        try:
            results[i] = p.communicate()  # reads both pipes until EOF
        except Exception:
            results[i] = ("", "")

    readers = [threading.Thread(target=_drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()

    def _kill_all():
        for q in procs:
            if q.poll() is None:
                q.kill()
        for t in readers:
            t.join(timeout=10)

    try:
        t0 = time.monotonic()
        for i, (p, t) in enumerate(zip(procs, readers)):
            t.join(timeout=max(0.1, timeout - (time.monotonic() - t0)))
            if t.is_alive():
                _kill_all()
                raise RuntimeError(
                    f"cluster child {p.args} hung past {timeout}s; "
                    f"killed all {len(procs)} processes")
            out, err = results[i]
            if p.returncode != 0:
                _kill_all()
                raise RuntimeError(
                    f"cluster child {p.args} exited {p.returncode}:\n"
                    f"--- stdout ---\n{out}\n--- stderr ---\n{err}")
        payloads = []
        for p, (out, err) in zip(procs, results):
            payload = _last_json_line(out)
            if payload is None:
                _kill_all()
                raise RuntimeError(
                    f"cluster child {p.args} printed no JSON payload:\n{out}")
            payloads.append(payload)
    except BaseException:
        _kill_all()
        raise
    return payloads
