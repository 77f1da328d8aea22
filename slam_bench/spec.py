"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics.  Everything that belongs to one configuration, one traffic mix,
one cell or one per-layer metric sits in a file of its own under this
folder, named after it:

- ``configs/<config>.json``: the deployment (scene, sequence length, the
  program's settings, the precision it states, its source and cuts);
- ``traffic/<traffic>.json``: the mix (arrivals, hints, the settings the
  traffic turns on);
- ``limits/<cell>.json``: the limit of each number the cell compares;
- ``metrics/<metric>.py``: a reader ``read(rec) -> float | None`` of one
  per-layer metric from the traced run's records.

A new cell, mix or metric is a new file and a new entry; no file here
changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


class Benchmark:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files of this
    folder (``base``, by default the folder beside the file)."""

    def __init__(self, root=None, base=None):
        self.base = base or HERE
        self.root = root or os.path.dirname(self.base)
        with open(os.path.join(self.root, "BENCHMARK.json")) as fh:
            self.doc = json.load(fh)

    def _json(self, kind, name):
        with open(os.path.join(self.base, kind, name + ".json")) as fh:
            return json.load(fh)

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json (%s)" % (
            name, ", ".join(w["name"] for w in self.doc["workloads"])))

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def metrics(self, kind: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries ``cell`` reports:
        those that list it, and those that list no cells."""
        return [m for m in self.doc[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``."""
        path = os.path.join(self.base, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "slam_bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
