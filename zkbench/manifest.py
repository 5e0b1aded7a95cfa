"""The benchmark's parts, found by name from BENCHMARK.json.

  * a configuration: its entry's ``file``, a JSON object of sizes;
  * a traffic mix: ``zkbench/workloads/<traffic>.json``, whose ``runner``
    names the general runner that reads it (``zkbench/runners/<runner>.py``);
  * a per-layer metric: ``zkbench/metrics/<name>.py``, a module with
    ``read(ctx)`` returning a number, or None where it finds nothing.

A later cell, configuration or metric is new files and a new entry; no
file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Bench:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root,
                               self._named("configs", name)["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(HERE, "workloads", f"{name}.json")) as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in reported)]


def runner(name: str):
    return importlib.import_module(f"zkbench.runners.{name}")


def reader(metric: str):
    """The reader module of a per-layer metric, loaded from its file."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"zkbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def units(metrics: List[dict]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in metrics}
