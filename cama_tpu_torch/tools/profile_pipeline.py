"""Profile the port's pipeline on a clip: a phase wall-clock report, and
optionally a torch.profiler trace of the warm pass (Chrome trace format,
for chrome://tracing or Perfetto).  The counterpart of
tools/profile_pipeline.py.

    python -m cama_tpu_torch.tools.profile_pipeline --clip <clip>
        [--source cama] [--mode auto|raster|sparse] [--chunk 8]
        [--raster-kernel auto|fused|pallas|compact|scatter]
        [--trace-dir DIR] [--with-images] [--eval] [--device cuda|cpu]

The device is 'cuda' unless --device cpu is given; without a card the tool
says so and exits 2.  torch.profiler can lose the card's events in a
process more than ~30 s old (profiling.device_trace): a trace that lost
launches is reported on stderr, and should be taken again from a fresh
process.

Reading the trace (--trace-dir; open the trace_<pid>_<ns>.json in Perfetto
or chrome://tracing): on a card it holds the card's kernels, memsets and
copies with the CUDA calls that launched them, and the program's own
spans, every PhaseTimers phase of the warm pass (device_dispatch,
sparse_fetch, host_composite, ...), on the card's clock: they sit on the host thread's track above the kernels,
category "cama_span", with args {id, parent}, the parent being the span
open around it on the same thread (0 for none).  So a gap between kernels
reads as the span open over it.  CPU operators are not recorded: they slow
the host and inflate its phases; profiling.device_trace(cpu_ops=True)
records them.  On the CPU the trace holds the CPU operators and the
spans.  The tool prints the spans written, those dropped past the span
log's capacity, and the clock drift at the trace's close (the closing
synchronisation by the host's clock against the trace's, in us).
"""
from __future__ import annotations

import argparse
import sys
import time
import warnings


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Phase report (and trace) of the port's pipeline.")
    parser.add_argument("--clip", required=True)
    parser.add_argument("--source", default="cama")
    parser.add_argument("--mode", default="auto",
                        choices=["auto", "raster", "sparse"],
                        help="serving mode of --with-images passes")
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--raster-kernel", default="auto",
                        choices=["auto", "fused", "pallas", "compact",
                                 "scatter"])
    parser.add_argument("--trace-dir", default=None)
    parser.add_argument("--with-images", action="store_true",
                        help="run the full composite path (needs the "
                             "camera JPEGs)")
    parser.add_argument("--eval", action="store_true",
                        help="also profile map evaluation (needs lane_ins "
                             "ground-truth masks)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from cama_tpu_torch.pipeline import ClipPipeline, resolve_device
    from cama_tpu_torch.profiling import device_trace

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"profile_pipeline: {e}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    pipe = ClipPipeline(clip_path=args.clip, chunk=args.chunk,
                        raster_kernel=args.raster_kernel, device=args.device)
    print(f"scene compile: {time.perf_counter() - t0:.2f}s "
          f"(sources: {pipe.scene.sources})")

    def run():
        if args.with_images:
            return sum(1 for _ in pipe.iter_frames(args.source,
                                                   mode=args.mode))
        return sum(1 for _ in pipe.iter_overlay_rasters(args.source))

    t0 = time.perf_counter()
    n = run()
    print(f"cold pass (counting pass, kernel builds and first-use "
          f"allocations included): {n} frames in "
          f"{time.perf_counter() - t0:.2f}s")

    pipe.timers = type(pipe.timers)()
    if args.trace_dir:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with device_trace(args.trace_dir, device=args.device) as prof:
                t0 = time.perf_counter()
                n = run()
        for w in caught:
            print(f"profile_pipeline: warning: {w.message}", file=sys.stderr)
        spans = prof.cama_spans
        print(f"profile_pipeline: trace spans {spans['spans']}, dropped "
              f"{spans['dropped']}, clock drift at close "
              f"{spans['clock_drift_us']:.1f} us", file=sys.stderr)
    else:
        t0 = time.perf_counter()
        n = run()
    dt = time.perf_counter() - t0
    print(f"warm pass: {n} frames in {dt:.2f}s ({n / dt:.1f} fps)")
    print(pipe.timers.report())
    if args.trace_dir:
        print("trace written to", args.trace_dir)

    if args.eval:
        from cama_tpu_torch.eval.map_metrics import MapEvaluator

        ev = MapEvaluator()
        k1 = pipe.crop_compact_k(args.source)
        P = int(pipe.scene.flat[args.source].points.shape[0])
        print("eval projections: "
              + (f"crop-compacted to k1={k1} of P={P}" if k1 is not None
                 else f"full P={P} (two-stage not engaged or sized)"))
        r = ev.evaluate_scene(pipe, args.source)  # cold: the GT store
        if not r["frames_evaluated"]:
            print("eval: no GT instance masks in clip — skipped")
            return 0
        ev.timers = type(ev.timers)()
        t0 = time.perf_counter()
        r = ev.evaluate_scene(pipe, args.source)
        dt = time.perf_counter() - t0
        print(f"warm eval: {r['frames_evaluated']} frames in {dt:.2f}s "
              f"({r['frames_evaluated'] / dt:.1f} fps)  "
              f"SRE={r['SRE']:.3f} P={r['precision']:.3f} "
              f"R={r['recall']:.3f}")
        print(ev.timers.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
