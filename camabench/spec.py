"""BENCHMARK.json and the files it names, found by name: a cell's entry,
its configuration file, its traffic file (traffic/<name>.json), a reader
module per metric (metrics/<name>.py), the entry kind a traffic file names
(entries/<entry>.py), a limit per compared number (limits/<name>.json) and
the yardstick's part for each device output (outputs/<name>.py).  Adding a
cell, a configuration, a traffic mix, a metric, an entry kind, a compared
number or a device output adds files and entries and edits none."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    def __init__(self, root=ROOT, here=HERE):
        self.root, self.here = root, here
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    cfg = json.load(f)
                if cfg.get("name") != name:
                    raise ValueError(f"{c['file']} names itself {cfg.get('name')!r}")
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        with open(os.path.join(self.here, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, workload, trace):
        """The cell's metric entries: its per-layer ones with trace, else its
        end-to-end ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or workload in m["workloads"]]

    def _module(self, folder, name, missing):
        path = os.path.join(self.here, folder, f"{name}.py")
        if not os.path.exists(path):
            raise missing
        spec = importlib.util.spec_from_file_location(f"camabench_{folder}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, entry):
        """The reader module of a metric entry, checked against it."""
        name = entry["name"]
        mod = self._module("metrics", name, FileNotFoundError(f"no metrics/{name}.py"))
        for key in ("unit", "source", "layer", "moves"):
            if key in entry and getattr(mod, key.upper()) != entry[key]:
                raise ValueError(f"metrics/{name}.py: {key} {getattr(mod, key.upper())!r} "
                                 f"!= BENCHMARK.json's {entry[key]!r}")
        return mod

    def entry(self, name):
        """The entry kind a traffic file names: a module with LOOP, the loop
        class (loops.py), and PRODUCES, what its passes count for the
        readers ("video_frames" or "evaluated_frames")."""
        return self._module("entries", name, ValueError(f"unknown traffic entry {name!r}"))

    def limit(self, name):
        """{"limit", "lower", "upper", "about"} of a compared number."""
        path = os.path.join(self.here, "limits", f"{name}.json")
        if not os.path.exists(path):
            raise KeyError(f"no limit for compared number {name!r}")
        with open(path) as f:
            return json.load(f)

    def output(self, name):
        """The yardstick's module for a device output: work(kept, eff, size,
        *extra) gives what the output adds to a frame's (bytes, operations)
        (work.frame_work)."""
        return self._module("outputs", name, ValueError(f"unknown device output {name!r}"))
