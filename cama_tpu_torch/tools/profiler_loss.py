"""How torch.profiler's record of the card changes as the process ages.

    python -m cama_tpu_torch.tools.profiler_loss [--seconds 180] [--every 20]

Every `--every` seconds for `--seconds`, traces one call of a fill and a
scatter on the card (the library call paint_max is held against) and
prints one JSON line: the process's age in seconds, the launch calls the
trace holds on the host side, how many of them lost their device event
(profiling.untraced_launches), and each traced device event's start minus
its launch call's start in microseconds (a kernel cannot start before its
launch: a negative value is the two clocks disagreeing).  Between traces
the card multiplies 4096 x 4096 matrices.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

T_START = time.perf_counter()


def traced_once(fn, path):
    """(calls, lost, [start - launch us]) of one traced call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cama_tpu_torch.profiling import untraced_launches

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    calls, lost = untraced_launches(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    skew = [round(e["ts"] - launch[e["args"]["correlation"]], 1)
            for e in events if e.get("cat") in ("kernel", "gpu_memset")
            and e.get("args", {}).get("correlation") in launch]
    return calls, lost, skew


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--every", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch

    dev = torch.device("cuda")
    n = 48 * 540 * 960  # one chunk's rasters, as chip_smoke.py paints them
    gen = torch.Generator(device=dev).manual_seed(0)
    flat = torch.randint(0, n, (46_070,), device=dev, generator=gen)
    prio = torch.randint(0, 7, (46_070,), device=dev, dtype=torch.int32,
                         generator=gen)

    def library():
        return torch.full((n,), -1, dtype=torch.int32,
                          device=dev).scatter_reduce_(0, flat, prio, "amax")

    a = torch.randn(4096, 4096, device=dev, generator=gen)
    path = os.path.join(tempfile.mkdtemp(), "trace.json")
    t_end = time.perf_counter() + args.seconds
    while True:
        calls, lost, skew = traced_once(library, path)
        print(json.dumps({"age_s": round(time.perf_counter() - T_START, 1),
                          "calls": calls, "lost": lost,
                          "start_minus_launch_us": skew}), flush=True)
        if time.perf_counter() >= t_end:
            break
        t_next = time.perf_counter() + args.every
        while time.perf_counter() < t_next:
            a = (a @ a).clamp_(-1.0, 1.0)
            torch.cuda.synchronize()
    os.remove(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
