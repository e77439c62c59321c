"""Run one cell of the benchmark once, on the CUDA card it is started on.

    python3 camabench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python3 -m camabench.run ...   (the same)

Set-up (from the process's start): the cell's fixtures from --seed, the
program's stores filled, the warm passes.  Then the window: closed-loop
passes of the cell's traffic until --seconds have passed, the pass in
flight finished.  With --trace 1 the window runs under torch.profiler
(CUDA activity only: trace.py) and the line carries the per-layer metrics,
else the end-to-end ones.  After
the window the program's state is dropped and what the window produced is
compared with the plain reference (camabench/reference).  The last line
of standard output is one JSON object: correct, attempted, failed,
metrics, device, breakdown (traced runs) and checks (each compared number
with its limit, also the last lines of standard error).

Exits 2 without a result when the card or cards the cell asks for are not
there, and 3 when jax, jaxlib, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from camabench import check, loops, work  # noqa: E402
from camabench.spec import Spec  # noqa: E402
from camabench.taps import Taps  # noqa: E402
from camabench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cama_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: cama_tpu_torch is not cama_tpu)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def execute(spec, workload, seed, seconds, trace, device, t_start, cache_root=None):
    """(result dict, error text or None) of one run of a cell."""
    import torch

    cell = spec.cell(workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    on_card = torch.device(device).type == "cuda"
    cache_root = cache_root or os.path.join(spec.here, ".cache")
    work_dir = tempfile.mkdtemp(prefix=f"camabench-{workload}-")
    taps = Taps(trace)
    taps.install()
    error = None
    try:
        loop = loops.make(spec, workload, cfg, traffic, int(seed) % (1 << 63), device,
                          cache_root, work_dir, taps)
        loop.setup()
        if on_card:
            torch.cuda.synchronize()
        os.sync()  # what set-up wrote reaches the disk before the window
        tracer = Tracer(work_dir) if trace and on_card else None
        taps.start_window()
        if tracer:
            tracer.start()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        frames = passes = failed = 0
        ends = []
        while True:
            passes += 1
            try:
                frames += loop.run_pass()
            except Exception:
                failed += 1
                error = traceback.format_exc()
                break
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        taps.stop_window()
        summary = tracer.stop(taps.spans) if tracer else None
        lengths = [round(b - a, 3) for a, b in zip([0.0] + ends, ends)]
        print(f"pass seconds: {lengths}", file=sys.stderr)
        print("phase seconds: " + json.dumps({k: round(v, 3) for k, v in
                                              sorted(taps.timer_totals().items())}),
              file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        name = torch.cuda.get_device_name(0) if on_card else "cpu"
        window_work = loop.work() if tracer else None
        loop.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        ok, checks = check.judge(loop.check(), spec)
        print(f"output check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    finally:
        taps.uninstall()
        shutil.rmtree(work_dir, ignore_errors=True)

    sound_trace = summary is not None and summary["lost"] == 0 and summary["busy_s"] > 0
    if summary is not None:
        print(f"trace: {summary['launches']} launches, {summary['lost']} lost, clocks "
              f"{summary['clock_drift_us']:.1f} us apart at the close", file=sys.stderr)
    if summary is not None and not sound_trace:
        print(f"the trace lost {summary['lost']} of {summary['launches']} device events "
              f"(busy {summary['busy_s']} s): device metrics left out", file=sys.stderr)
    readings = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, frames=frames, passes=passes - failed,
        timers=taps.timer_totals(), produces=loop.produces,
        trace=summary if sound_trace else None,
        least_s=(work.least_seconds(window_work, (cfg["output_height"], cfg["output_width"]),
                                    spec.output(traffic["device_output"]), name)
                 if sound_trace else None))
    metrics = {}
    for entry in spec.metrics(workload, trace):
        value = spec.reader(entry).read(readings)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": bool(ok and failed == 0 and frames > 0), "attempted": passes,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": name,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if sound_trace:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result, error


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, error = execute(spec, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    if error:
        print(error, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r}, limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
