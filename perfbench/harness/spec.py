"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

* configuration ``<c>``: ``configs/<c>.json``; its ``system`` names
  ``systems/<system>.py`` and its ``reference`` names
  ``reference/<reference>.py``;
* traffic ``<t>``: ``traffic/<t>.json``;
* metric ``<m>``: ``metrics/<m>.py``, whose ``read(run)`` returns the
  metric's value or None.

A later cell, configuration, mix or metric is added as files and
entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[workload]
        self.name = workload
        cname = self.entry["config"]
        self.config = json.loads(
            (self.dir / "configs" / f"{cname}.json").read_text())
        self.traffic = json.loads(
            (self.dir / "traffic" / f"{self.entry['traffic']}.json")
            .read_text())

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: end-to-end ones untraced,
        per-layer ones traced, each where its ``workloads`` (if given)
        lists the cell."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"perfbench_metric_{metric.replace('.', '_')}")

    def system_module(self):
        name = self.config["system"]
        return load_module(self.dir / "systems" / f"{name}.py",
                           f"perfbench_system_{name}")

    def reference_module(self):
        name = self.config["reference"]
        return load_module(self.dir / "reference" / f"{name}.py",
                           f"perfbench_reference_{name}")
