"""Static invariant verification for the port (the counterpart of
``repro.analysis``), over ``src/repro_torch``.

Three lint passes plus a lattice auditor that runs no step, runnable as
``python -m repro_torch.analysis`` (``--strict`` exits 1 on any
unsuppressed finding):

* ``step_hazards`` — host side effects, Python control flow on a
  tensor's value, host syncs and nondeterminism in functions reachable
  from the serving step (``Engine._step_impl``): what a CUDA graph of the
  step forbids.
* ``leases`` — every block-reference/pin/queued-op acquire in the port's
  block manager, prefix store, scheduler and server is released (or
  escapes into owned state) on every exit path, fault paths included.
* ``registry`` — the port's counter names, fault sites and docs agree
  across emitters, the frozen schema of ``tests/test_torch_perf_counters.
  py`` and the README's port section and ``PERF.md``.
* ``lattice`` — enumerates the occupancy bucket lattice, sizes each
  bucket on the meta device against a device budget, and predicts the
  exact bucket-key set of the gate workloads by replaying the control
  plane in simulation.

Suppression grammar (reason mandatory, counted in the report)::

    # repro: allow(<pass>) — <reason>
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.common import Finding, SourceFile, iter_py_files

__all__ = ["Finding", "run_all", "collect_malformed_allows"]


def collect_malformed_allows(root: Path) -> List[Finding]:
    """Bare ``# repro: allow(...)`` comments without a reason in the port
    (``src/repro_torch``, ``tests/test_torch_*.py``) — they do not
    suppress anything, so surface them as findings of their own."""
    paths = iter_py_files(root, "src/repro_torch")
    if (root / "tests").is_dir():
        paths += sorted((root / "tests").glob("test_torch_*.py"))
    out: List[Finding] = []
    for p in paths:
        sf = SourceFile.load(p, root)
        for line in sf.malformed:
            out.append(Finding(
                "allow", sf.rel, line, "malformed-allow",
                "allow comment has no reason — write "
                "'# repro: allow(<pass>) — <why>'"))
    return out


def run_all(root: Path, device_budget_bytes: Optional[int] = None,
            predict: bool = True
            ) -> Tuple[Dict[str, object], List[Finding]]:
    """All passes + the lattice audit.  Returns (report, findings)."""
    from repro_torch.analysis import lattice, leases, registry, step_hazards
    findings: List[Finding] = []
    findings += step_hazards.run(root)
    findings += leases.run(root)
    findings += registry.run(root)
    findings += collect_malformed_allows(root)
    report, lattice_findings = lattice.audit(
        root, device_budget_bytes=device_budget_bytes, predict=predict)
    report["not_run"] = {f"registry/{k}": v
                         for k, v in registry.NOT_RUN.items()}
    findings += lattice_findings
    return report, findings
