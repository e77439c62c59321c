"""BENCHMARK.json and the files it names, found by name: a cell's entry,
its configuration file, its traffic file (traffic/<name>.json) and a
reader module per metric (metrics/<name>.py).  Adding a cell, a
configuration, a traffic mix or a metric adds files and entries and edits
none."""
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

    def reader(self, entry):
        """The reader module of a metric entry, checked against it."""
        name = entry["name"]
        path = os.path.join(self.here, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"camabench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for key in ("unit", "source", "layer", "moves"):
            if key in entry and getattr(mod, key.upper()) != entry[key]:
                raise ValueError(f"metrics/{name}.py: {key} {getattr(mod, key.upper())!r} "
                                 f"!= BENCHMARK.json's {entry[key]!r}")
        return mod
