"""Agent serving example (§6.5): Continuum TTL pinning + AsymCache.

Tool-calling jobs where each model turn triggers a tool with a
predictable duration; Continuum pins the request's KV blocks for the
tool's TTL, and AsymCache orders eviction *within* the unpinned
population by expected recomputation latency.  Discrete-event at paper
scale (H20 cost model): no model, no device.

    PYTHONPATH=src python -m repro_torch.examples.agentic_continuum
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

from repro_torch.examples.paper_scale import bfcl_like, pressured_server

SYSTEMS = [
    ("vLLM-LRU", "lru", False),
    ("AsymCache", "asymcache", False),
    ("Continuum", "lru", True),
    ("Continuum+AsymCache", "asymcache", True),
]


def run(n_jobs: int = 16) -> Dict[str, Dict]:
    """Each system's run summary on ``bfcl_like(n_jobs, qps=0.5,
    seed=11)`` with a cache of 0.25x the workload's footprint."""
    results = {}
    for name, policy, ttl in SYSTEMS:
        wl = bfcl_like(n_jobs, qps=0.5, seed=11)
        srv = pressured_server(policy, wl, pressure=0.25, continuum=ttl,
                               lifespan=10.0)
        results[name] = srv.run(wl)
    return results


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.examples.agentic_continuum",
        description=__doc__.splitlines()[0]).parse_args(argv)
    results = run()
    print(f"{'system':<22} {'job lat(s)':>10} {'P90(s)':>8} {'hit':>6}")
    for name, _, _ in SYSTEMS:
        r = results[name]
        print(f"{name:<22} {r['job_latency_mean']:>10.2f} "
              f"{r['job_latency_p90']:>8.2f} {r['block_hit_rate']:>6.1%}")
    base = results["Continuum"]["job_latency_mean"]
    ours = results["Continuum+AsymCache"]["job_latency_mean"]
    print(f"\nContinuum+AsymCache vs Continuum: "
          f"{(1 - ours / base) * 100:+.1f}% average job latency")
    return 0


if __name__ == "__main__":
    sys.exit(main())
