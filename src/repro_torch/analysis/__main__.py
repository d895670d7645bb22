"""CLI: ``python -m repro_torch.analysis [--strict] [--report PATH]
[--no-predict] [--collectives]``.

Prints every finding as ``file:line: pass/code: message``, writes the
JSON report (default ``results/analysis_torch.json``, gitignored), and
(``--strict``) exits nonzero when any unsuppressed finding remains.
Suppressed findings are listed and counted but never affect the exit
code — the suppression comment itself carries the reviewable reason.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _find_root(start: Path) -> Path:
    p = start.resolve()
    for cand in (p, *p.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    # installed-package fallback: .../src/repro_torch/analysis/__main__.py
    return Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-analyze",
        description="static invariant verification for the port")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any unsuppressed finding")
    ap.add_argument("--report", type=Path, default=None,
                    help="where to write the JSON report (default: "
                         "results/analysis_torch.json under the root)")
    ap.add_argument("--device-budget-bytes", type=int, default=None,
                    help="per-bucket footprint budget (default: 2 GiB)")
    ap.add_argument("--no-predict", action="store_true",
                    help="skip the control-plane replay (lattice "
                         "enumeration and footprints only)")
    ap.add_argument("--collectives", action="store_true",
                    help="ALSO run one 2-shard step per bucket on the CPU "
                         "and count its collectives")
    args = ap.parse_args(argv)

    root = args.root or _find_root(Path.cwd())
    report_path = args.report or root / "results" / "analysis_torch.json"
    from repro_torch.analysis import run_all
    report, findings = run_all(root,
                               device_budget_bytes=args.device_budget_bytes,
                               predict=not args.no_predict)

    if args.collectives:
        from repro_torch.analysis.lattice import _gate_setup, collective_probe
        from repro_torch.models import init_params
        cfg, scfg, ecfg = _gate_setup()
        params = init_params(cfg, seed=0, device="cpu")
        report["collectives"] = collective_probe(cfg, params, scfg,
                                                 ecfg=ecfg)

    unsuppressed = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    for f in findings:
        print(f.render())
    for name, why in sorted(report.get("not_run", {}).items()):
        print(f"not run: {name}: {why}")
    print(f"{len(unsuppressed)} finding(s), "
          f"{len(suppressed)} suppressed")

    report["findings"] = [f.to_json() for f in findings]
    report["summary"] = {
        "unsuppressed": len(unsuppressed),
        "suppressed": len(suppressed),
        "by_pass": _by_pass(findings),
    }
    report_path.parent.mkdir(parents=True, exist_ok=True)
    report_path.write_text(json.dumps(report, indent=2, sort_keys=True)
                           + "\n")
    print(f"report written to {report_path}")

    if args.strict and unsuppressed:
        return 1
    return 0


def _by_pass(findings):
    out = {}
    for f in findings:
        d = out.setdefault(f.pass_name, {"unsuppressed": 0,
                                         "suppressed": 0})
        d["suppressed" if f.suppressed else "unsuppressed"] += 1
    return out


if __name__ == "__main__":
    sys.exit(main())
