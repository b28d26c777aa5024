"""Every file of a configuration, traffic mix, cell, driver or metric is
found by the name ``BENCHMARK.json`` gives it, so a later change adds a file
and an entry and edits none:

  benchmark/configs/<config>.json      the configuration as it is run
  benchmark/traffic/<traffic>.json     the traffic's parameters and driver
  benchmark/workloads/<cell>.json      the cell's limits of ``correct``
  benchmark/drivers/<driver>.py        the entry the window drives
  benchmark/metrics/<metric>.py        the reader of one metric
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Registry:
    """The benchmark rooted at ``root`` (a checkout holding
    ``BENCHMARK.json`` and ``benchmark/``)."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "benchmark")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        """The cell's ``BENCHMARK.json`` entry with its file's keys."""
        entry = dict(self._entry("workloads", name))
        entry.update(_load_json(os.path.join(self.dir, "workloads",
                                             name + ".json")))
        return entry

    def config(self, name: str) -> dict:
        return _load_json(os.path.join(self.root,
                                       self._entry("configs", name)["file"]))

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.dir, "traffic", name + ".json"))

    def driver(self, name: str):
        return _load_module(os.path.join(self.dir, "drivers", name + ".py"),
                            f"benchmark.drivers.{name}")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: ``per_layer`` with
        ``trace``, else ``end_to_end``, each listing the cell or no cell."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """The metric's reader: a module with ``read(ctx) -> float | None``."""
        return _load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                            "benchmark.metrics." + metric.replace(".", "_"))
