"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the
root of the checkout lists the cells and the metrics; each configuration
is ``portbench/configs/<name>.json``, each traffic mix
``portbench/traffic/<name>.json``, each metric's reader
``portbench/metrics/<name>.py`` (a module with ``read(ctx)``, which returns
a number or None where it finds nothing to read), and the model family a
configuration names ``portbench/families/<family>/``
(:mod:`portbench.families`).  A cell, configuration, traffic mix, metric
or family is added by adding its files and its entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, root: Path = HERE, benchmark: Path = None):
        self.root = Path(root)
        path = Path(benchmark) if benchmark else self.root.parent / "BENCHMARK.json"
        with open(path) as f:
            self.benchmark = json.load(f)

    def _json(self, kind: str, name: str) -> dict:
        with open(self.root / kind / f"{name}.json") as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        found = [w for w in self.benchmark["workloads"] if w["name"] == name]
        if not found:
            known = ", ".join(w["name"] for w in self.benchmark["workloads"])
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
        return found[0]

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def reader(self, metric: str) -> ModuleType:
        path = self.root / "metrics" / f"{metric}.py"
        module_spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        return module

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics that ``cell`` reports."""
        return [m for m in self.benchmark["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics that ``cell`` reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.benchmark["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
