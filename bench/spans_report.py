"""The program's spans in one cell, three runs in one process (never a
benchmark run):

    python3 bench/spans_report.py --workload granite8b.batch \
        --seed 2147483901 --seconds 51

* ``off``: an untraced run, as the benchmark's;
* ``on``: an untraced run with the program's tracer on for the whole
  run (``AsymCacheServer.enable_tracing``): what tracing costs when on
  (``control_plane_ms``, the window's steps, ``itl_p90_s`` against
  ``off``), and the spans' coverage and consistency over the window
  (``bench/harness/spans.py``'s ``report``);
* ``traced``: the benchmark's ``--trace 1`` run, the tracer following
  its profiler: every per-layer metric, and the stretch's device-idle
  time by innermost program span.

One JSON line a run on standard output.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench.harness import cell, spans  # noqa: E402
from bench.harness.spec import Spec  # noqa: E402


class _Reporting(Spec):
    """The spec whose readers also take the spans' report of the run,
    once, while its server is still there."""

    def __init__(self, root):
        super().__init__(root)
        self.report = None

    def reader(self, metric):
        read = super().reader(metric)

        def reporting(run):
            if self.report is None:
                self.report = spans.report(run) or {}
            return read(run)
        return reporting


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("spans_report: no CUDA card")
    for mode in ("off", "on", "traced"):
        spec = _Reporting(ROOT)
        on = (lambda s: s.enable_tracing()) if mode == "on" else None
        out = cell.run(spec, args.workload, args.seed, args.seconds,
                       mode == "traced", "cuda", time.perf_counter(),
                       on_server=on, every_metric=mode != "traced")
        line = {"workload": args.workload, "seed": args.seed, "mode": mode,
                "correct": out["correct"],
                "metrics": {k: v["value"]
                            for k, v in out["metrics"].items()},
                "steps_window": out["detail"]["steps_window"],
                "device": out["device"], "report": spec.report}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
