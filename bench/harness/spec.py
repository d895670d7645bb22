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
  returns the metric's value or None where it finds nothing to read;
* a configuration's module: ``bench/reference/<module>.py``, named by
  the configuration file's optional ``"reference"`` key
  (``bench/reference/model.py`` without it).  It holds what is
  particular to the model:

  - ``leaves(cfg)``: the ``(path, shape, scale)`` of every parameter
    of the port's ``ModelConfig``, in the order the weights are drawn
    (``bench/harness/weights.py``);
  - ``logits_at(params, model, seqs, keep, quant=None)``: the plain
    reference (``bench/harness/check.py``); it imports nothing of the
    program;

  and, where the harness's generic one does not fit:

  - ``model_config(cfg_file, build)``: the port's ``ModelConfig``;
    ``build`` is the generic ``weights.model_config``, so the module
    can rewrite the file's ``model`` block before it, or the result
    after it, and still import nothing of the program;
  - ``params_per_row(model, layer)`` and ``attn_layer(work, model,
    page, layer)``: the work counts (``bench/harness/flops.py``) that
    ``step_mfu``, ``attn_roofline`` and any later metric read through
    ``Run.reference``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
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
        return self._module("metrics", metric).read

    def reference(self, cfg_file: Dict):
        """The configuration's module (see above)."""
        return self._module("reference", cfg_file.get("reference", "model"))

    def _module(self, kind: str, name: str):
        """``bench/<kind>/<name>.py``, loaded by its path (and entered in
        ``sys.modules``, where a dataclass of the module looks itself up)."""
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench.{kind}.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod
