"""Environment self-check of the PyTorch port: one bounded JSON report of
everything a run depends on (the card, the toolchain that builds the
kernels, the kernel library, the host compositor, ffmpeg, each configured
scene's caches).

    python -m cama_tpu_torch.doctor [-c config.yaml] [--timeout 60]

Counterpart of cama_tpu/doctor.py.  Every subprocess (nvidia-smi, nvcc,
g++) is bounded by --timeout.  "reference_mounted" looks for a checkout of
the reference CAMA under $CAMA_REFERENCE_DIR (default ~/reference).  Exit
0 always: the report is the product, and a missing card is reported as
"reachable": false, not hidden; automation should read the JSON, not the
exit code.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import time

# where a checkout of the reference CAMA implementation is looked for
REFERENCE_DIR = os.environ.get(
    "CAMA_REFERENCE_DIR", os.path.join(os.path.expanduser("~"), "reference"))


def _first_line(cmd, timeout, match=None):
    """The first output line of cmd (the first containing `match` when
    given), or None when the program is missing, fails or times out."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.SubprocessError):
        return None
    if proc.returncode != 0:
        return None
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    if match is not None:
        lines = [ln for ln in lines if match in ln]
    return lines[0] if lines else None


def check_backend(timeout):
    """The card: reachability, count, name, capability, nvidia-smi's name
    and power limit, and (when reachable) a dispatch and a 4 MB round-trip
    micro-probe."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    out = {"torch": torch.__version__, "torch_cuda": torch.version.cuda}
    if not torch.cuda.is_available():
        out.update({"reachable": False,
                    "probe_seconds": round(time.perf_counter() - t0, 2),
                    "note": "torch.cuda.is_available() is False: no CUDA "
                            "card, or a CPU-only torch; the entry points "
                            "need --device cpu here"})
        return out
    out.update({"reachable": True, "platform": "cuda",
                "devices": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(0),
                "capability": list(torch.cuda.get_device_capability(0)),
                "nvidia_smi": _first_line(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], timeout)})
    try:
        dev = torch.device("cuda")
        x = torch.ones((8, 8), dtype=torch.float32, device=dev)

        def fn(a):
            return (a @ a).sum().item()

        fn(x)  # first use: context, handles
        t1 = time.perf_counter()
        fn(x)
        out["dispatch_ms"] = round((time.perf_counter() - t1) * 1000, 3)
        mb = np.zeros((4 * 1024 * 1024,), np.uint8)  # 4 MB each way
        t1 = time.perf_counter()
        torch.from_numpy(mb).to(dev).cpu().numpy()[0]
        out["roundtrip_MBps"] = round(8 / (time.perf_counter() - t1), 1)
    except Exception as e:  # the probe is best-effort
        out["probe_error"] = repr(e)[:200]
    out["probe_seconds"] = round(time.perf_counter() - t0, 2)
    return out


def check_toolchain(timeout):
    """The compilers that build the kernels (nvcc) and the host compositor
    (g++), and whether the kernel library is built for the current
    sources."""
    from cama_tpu_torch import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    out = {"nvcc": nvcc and _first_line([nvcc, "--version"], timeout,
                                        match="release"),
           "g++": _first_line(["g++", "--version"], timeout)}
    try:
        lib = _build.library_path()
        out["kernels"] = {"library": lib, "built": os.path.exists(lib)}
    except RuntimeError as e:  # no writable build directory
        out["kernels"] = {"library": None, "built": False, "error": str(e)}
    return out


def check_scene(configs, name):
    """Per-scene readiness: converted? scene cache? frame cache? GT masks?"""
    from cama_tpu_torch.io.scene import DEFAULT_CAMA_CONFIGS

    cc = {**DEFAULT_CAMA_CONFIGS, **(configs.get("cama_configs") or {})}
    clip = os.path.join(configs["converted_dataroot"], name)
    out = {"converted": os.path.exists(os.path.join(clip, "attribute.json"))}
    if not out["converted"]:
        return out
    cache_dir = cc.get("scene_cache_dir") or os.path.join(clip, ".cama_tpu")
    out["scene_cache"] = bool(
        [f for f in (os.listdir(cache_dir) if os.path.isdir(cache_dir) else [])
         if f.startswith("scene_cache")])
    fdir = cc.get("frame_cache_dir") or os.path.join(clip, ".cama_tpu")
    frames = [f for f in (os.listdir(fdir) if os.path.isdir(fdir) else [])
              if f.startswith("frames_") and f.endswith(".valid.npy")]
    if frames:
        import numpy as np

        v = np.load(os.path.join(fdir, frames[0]), mmap_mode="r")
        out["frame_cache_hit_rate"] = round(float(np.asarray(v).mean()), 3)
    else:
        out["frame_cache_hit_rate"] = 0.0
    out["gt_masks"] = any(
        d.startswith("lane_ins_") for d in os.listdir(clip)
        if os.path.isdir(os.path.join(clip, d)))
    out["labels"] = {
        "cama": os.path.exists(os.path.join(clip, cc["result_dir"],
                                            cc["cama_map_file"])),
        "nuscenes": os.path.exists(os.path.join(clip, cc["result_dir"],
                                                cc["nuscenes_map_file"])),
    }
    return out


def find_nuscenes_dataroot():
    """First existing nuScenes dataroot among NUSCENES_DATAROOT and the
    conventional locations (a dataroot is a dir holding a v1.0-* table
    directory)."""
    candidates = [os.environ.get("NUSCENES_DATAROOT"), "/data/nuscenes",
                  "/data/sets/nuscenes",
                  os.path.expanduser("~/nuscenes")]
    for root in candidates:
        if not root or not os.path.isdir(root):
            continue
        try:
            if any(n.startswith("v1.0") for n in os.listdir(root)):
                return root
        except OSError:
            continue
    return None


def check_converter_readiness():
    """Real-data converter prerequisites: is the nuScenes devkit importable,
    is a dataroot discoverable, and what single command runs the byte-diff
    gate vs the reference converter."""
    try:
        import nuscenes  # noqa: F401

        devkit = True
    except ImportError:
        devkit = False
    dataroot = find_nuscenes_dataroot()
    ready = devkit and dataroot is not None
    out = {"devkit_installed": devkit, "dataroot": dataroot, "ready": ready}
    if ready:
        out["run"] = "python tools/validate_convert_real.py  # auto-discovers this dataroot, converts scene-0061 with both implementations, byte-diffs"
    else:
        missing = ([] if devkit else ["pip install nuscenes-devkit"]) + \
            ([] if dataroot else ["download v1.0-mini and set NUSCENES_DATAROOT"])
        out["to_enable"] = missing
    return out


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Bounded environment self-check (one JSON report)")
    parser.add_argument("-c", "--config", default=None,
                        help="also check each configured scene's readiness")
    parser.add_argument("--timeout", type=float, default=60.0,
                        help="bound in seconds of each probe subprocess "
                             "(default 60)")
    args = parser.parse_args(argv)

    from cama_tpu_torch import native

    toolchain = check_toolchain(args.timeout)
    lib = toolchain["kernels"]["library"]
    cache_dir = os.path.dirname(lib) if lib else None
    report = {
        "backend": check_backend(args.timeout),
        "toolchain": toolchain,
        "native_compositor": native.available(),
        "ffmpeg": bool(shutil.which("ffmpeg")),
        "encoder": ("ffmpeg/libx264" if shutil.which("ffmpeg")
                    else "cv2/mp4v fallback"),
        "compile_cache": {
            "dir": cache_dir,
            "entries": (len(os.listdir(cache_dir))
                        if cache_dir and os.path.isdir(cache_dir) else 0),
            "note": "the kernel library and the host compositor, built at "
                    "first use and named by a hash of their sources",
        },
        "reference_mounted": os.path.isdir(os.path.join(REFERENCE_DIR,
                                                        "cama")),
        "nuscenes_converter": check_converter_readiness(),
    }
    if args.config:
        from cama_tpu_torch.config import load_config

        configs, _ = load_config(args.config)
        report["scenes"] = {
            name: check_scene(configs, name)
            for name in dict.fromkeys(configs["scene_names"])}

    print(json.dumps(report))
    return 0


def main_entry(argv=None):
    """Console-script / python -m entry point."""
    raise SystemExit(main(argv))


if __name__ == "__main__":
    main_entry()
