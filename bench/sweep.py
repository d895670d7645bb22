"""Runs of one cell in one process, for the knee sweep and for the
calibration of the correctness limit (never a benchmark run):

    python3 bench/sweep.py --workload grok1.chat --seeds 5,6 \
        --rates 1.3,1.6,2.0 --seconds 30 [--warm 80] [--control 1]

One JSON line a (seed, rate) (as many seeds as rates pair them, one
seed a rate; otherwise every seed runs every rate): every metric of the
cell (the traced ones excepted), the window's requests, the queue and
the counters at its start and its end (a backlog that grows shows as
requests still waiting and a TTFT that climbs), and the numbers
compared, with the fp8 control's under ``--control 1``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench.harness import cell  # noqa: E402
from bench.harness.spec import Spec  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--warm", type=float, default=None)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep: no CUDA card")
    spec = Spec(ROOT)
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    seeds = [int(s) for s in args.seeds.split(",")]
    # as many seeds as rates: one seed a rate; else every pair
    pairs = list(zip(seeds, rates)) if len(seeds) == len(rates) > 1 \
        else [(s, r) for s in seeds for r in rates]
    for seed, rate in pairs:
        t = time.perf_counter()
        out = cell.run(spec, args.workload, seed, args.seconds, False,
                       "cuda", t, control=bool(args.control),
                       rate=rate, warm_s=args.warm, every_metric=True)
        line = {"workload": args.workload, "seed": seed, "rate": rate,
                "correct": out["correct"],
                "control_correct": out.get("control_correct"),
                "check": out["check"],
                "control_check": out.get("control_check"),
                "attempted": out["attempted"], "failed": out["failed"],
                "metrics": {k: v["value"]
                            for k, v in out["metrics"].items()},
                "memory_peak_gib": out["device"]["memory_peak_bytes"]
                / 2**30,
                "detail": out["detail"],
                "run_s": time.perf_counter() - t}
        print("sweep: " + json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
