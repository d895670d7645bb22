"""Rehearse a cell's traffic on the CPU, without the model: the server's
discrete-event mode (``execute_model=False``, the model clock priced by
the port's cost model) at the cell's pool size and rate, through the
same sources and window as a benchmark run.

    python3 bench/rehearse.py --workload grok1.chat --seed 1 \
        --seconds 51 [--rate 1.0]

Prints the window's requests and tokens, the evictions, the
multi-segment prefill chunks and the share of prompt tokens that
recomputed history in the window, and the live sessions' history
(tokens) against the pool, sampled each second of the window.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402

from bench.harness import cell  # noqa: E402
from bench.harness.spec import Spec  # noqa: E402
from bench.harness.traffic import generate  # noqa: E402


def recompute_share(requests, t0: float, t1: float):
    """Percent of the prompt tokens computed for turns that arrived in
    ``[t0, t1)`` that recomputed history their session had computed
    before: a turn's computed prompt beyond its own new tokens (its
    prompt less the previous turn's prompt and output)."""
    prev, recomputed, computed = {}, 0, 0
    for r in sorted(requests, key=lambda r: r.rid):
        p = prev.get(r.session_id)
        prev[r.session_id] = r
        if not t0 <= r.arrival < t1 or np.isnan(r.admitted_at):
            continue
        computed += r.n_prefill_compute
        if p is not None:
            new = r.prompt_len - p.prompt_len - len(p.generated)
            recomputed += max(0, r.n_prefill_compute - new)
    return 100.0 * recomputed / computed if computed else None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args()
    spec = Spec(ROOT)
    wl = spec.workload(args.workload)
    traffic = spec.traffic(wl["traffic"])
    cfg = spec.config(wl["config"])
    sessions = generate(traffic, args.seed, cfg["model"]["vocab_size"],
                        traffic["warm_s"] + args.seconds, args.rate)
    n_turns = {s.sid: len(s.turns) for s in sessions}
    seen = {}

    def watch(server):
        dispatch = server.engine.dispatch
        submit = server.sched.submit
        live, last = [], {}

        def submitted(req):
            last[req.session_id] = req
            seen.setdefault("requests", []).append(req)
            return submit(req)
        server.sched.submit = submitted

        def counted(plan):
            segs = sum(1 for c in plan.prefills
                       if np.any(np.diff(np.asarray(c.positions)) > 1))
            seen.setdefault("steps", []).append((server.now, segs,
                                                 len(plan.decodes)))
            if not live or server.now >= live[-1][0] + 1.0:
                ctx = [r.prompt_len + len(r.generated)
                       for r in last.values()
                       if not r.terminal or (
                           r.status == "finished"
                           and r.turn_index < n_turns[r.session_id] - 1)]
                live.append((server.now, sum(ctx), len(ctx)))
            return dispatch(plan)
        server.engine.dispatch = counted
        seen["live"] = live
        seen["server"] = server

    t = time.perf_counter()
    out = cell.run(spec, args.workload, args.seed, args.seconds, False,
                   "cpu", t, rate=args.rate, simulate=True,
                   on_server=watch)
    srv = seen["server"]
    t0 = traffic["warm_s"]
    t1 = t0 + args.seconds
    steps = [s for s in seen["steps"] if t0 <= s[0] < t1]
    live = [x for x in seen["live"] if t0 <= x[0] < t1]
    pool = srv.scfg.num_blocks * srv.scfg.block_size
    share = recompute_share(seen.get("requests", []), t0, t1)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "rate": args.rate or traffic["arrival"].get("rate_per_s"),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "evictions_run": srv.bm.n_evictions,
        "recompute_share_pct": share,
        "steps_window": len(steps),
        "multi_segment_chunks_window": sum(s[1] for s in steps),
        "mean_decodes": float(np.mean([s[2] for s in steps]))
        if steps else None,
        "pool_tokens": pool,
        "window": out["detail"]["window"],
        "live_history_tokens_mean": float(np.mean([x[1] for x in live]))
        if live else None,
        "live_history_tokens_max": max((x[1] for x in live), default=0),
        "live_sessions_mean": float(np.mean([x[2] for x in live]))
        if live else None}))


if __name__ == "__main__":
    main()
