"""Finding every piece of a cell by its name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), their configurations and traffic mixes, and the
metrics.  Each piece is a file of its own under ``bench/``:

* a configuration: ``bench/configs/<config>.json``;
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a cell's correctness limits: ``bench/limits/<workload>.json`` (each
  number it names is compared with its limit; ``*_reading`` keys and
  ``readings`` record what the limit was set from);
* a metric's reader: ``bench/metrics/<metric>.py``, whose ``read(run)``
  returns the metric's value or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "bench"

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> Dict:
        return self._json("limits", workload)

    def _json(self, kind: str, name: str) -> Dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> List[Dict]:
        """The cell's end-to-end metrics (``traced`` False) or per-layer
        metrics (True): every entry without a ``workloads`` key, and those
        whose ``workloads`` name the cell."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[key]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench.metrics.{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
