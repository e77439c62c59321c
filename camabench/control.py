"""Readings behind the limits of limits/<name>.json: per seed, the numbers
a run compares, from the program (a short window at the cell's own load) and
from the control, the reference computed in bfloat16 in the program's
place, on the same inputs, all in one process.

    python3 camabench/control.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--passes 2]

One JSON line per seed: {"seed", "program": {number: value},
"control": {number: value} or null, "limits": {number: limit}}, each limit
as run.py judges by it (Spec.limit).  Needs the card, as run.py does.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from camabench import loops  # noqa: E402
from camabench.spec import Spec  # noqa: E402
from camabench.taps import Taps  # noqa: E402


def readings(spec, workload, seeds, control_seeds, passes, device, cache_root=None):
    """Yield one reading dict per seed."""
    cell = spec.cell(workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    cache_root = cache_root or os.path.join(spec.here, ".cache")
    taps = Taps(False)
    taps.install()
    try:
        yield from _seeds(spec, workload, cfg, traffic, seeds, control_seeds, passes,
                          device, cache_root, taps)
    finally:
        taps.uninstall()


def _seeds(spec, workload, cfg, traffic, seeds, control_seeds, passes, device,
           cache_root, taps):
    import torch

    for seed in seeds:
        work_dir = tempfile.mkdtemp(prefix=f"camabench-control-{workload}-")
        try:
            loop = loops.make(spec, workload, cfg, traffic, seed, device, cache_root,
                              work_dir, taps)
            loop.setup()
            taps.start_window()
            for _ in range(passes):
                loop.run_pass()
            taps.stop_window()
            loop.release()
            gc.collect()
            program = loop.check()
            out = {"seed": seed, "program": program, "control": None,
                   "limits": {k: spec.limit(k)["limit"] for k in program}}
            if seed in control_seeds:
                out["control"] = loop.control(torch.bfloat16)
            yield out
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for r in readings(Spec(), args.workload, seeds, ctl, args.passes, "cuda"):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
