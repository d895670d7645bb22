"""End-to-end serving driver: policy comparison on a multi-turn workload.

Runs the same trace through AsymCache / LRU / Pensieve / Max-Score at
paper scale (discrete-event mode with the Eq.-6 cost model on H20
constants) and prints the Fig-11-style table.

    PYTHONPATH=src python -m repro_torch.examples.serve_multiturn \
        [--sessions N] [--real [--device cpu]]

``--real`` runs the engine on a reduced model instead (on the card, or
on the CPU with ``--device cpu``) and verifies losslessness on the fly.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.examples._smoke import (device_ok, logit_errors,
                                         multi_turn_server, smoke_model)
from repro_torch.examples.paper_scale import longbench_like, pressured_server
from repro_torch.examples.quickstart import WORKLOAD
from repro_torch.serving import WorkloadConfig, multi_turn_workload

POLICIES = ("asymcache", "lru", "maxscore", "pensieve")
NUM_BLOCKS = 56           # quickstart's workload over a tighter pool


def run_sim(n_sessions: int = 12) -> Dict[str, Dict]:
    """Each policy's run summary on ``longbench_like(n_sessions, qps=0.2,
    intra_ratio=10.0, seed=1)`` with a cache of 0.3x its footprint."""
    results = {}
    for policy in POLICIES:
        wl = longbench_like(n_sessions, qps=0.2, intra_ratio=10.0, seed=1)
        srv = pressured_server(policy, wl, pressure=0.3, lifespan=100.0)
        results[policy] = srv.run(wl)
    return results


def run_real(cfg: Optional[ModelConfig] = None, params: Optional[Dict] = None,
             workload_cfg: WorkloadConfig = WORKLOAD, clock: str = "wall",
             device="cuda") -> Dict:
    """Serve ``workload_cfg`` over a 56-block pool: ``{"summary",
    "requests", "worst_abs_err": the worst first-logit |difference| from
    the dense reference}``."""
    cfg, params, dev = smoke_model(cfg, params, device)
    wl = multi_turn_workload(workload_cfg)
    r = multi_turn_server(cfg, params, dev, NUM_BLOCKS, clock).run(wl)
    return {"summary": r, "requests": wl,
            "worst_abs_err": logit_errors(cfg, params, wl)[1]}


def main(argv=None) -> int:
    prog = "python -m repro_torch.examples.serve_multiturn"
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--sessions", type=int, default=12)
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="--real: where the model runs: cuda, cuda:<i> or "
                         "cpu")
    a = ap.parse_args(argv)
    if a.real:
        if not device_ok(a.device, prog):
            return 2
        out = run_real(device=a.device)
        r = out["summary"]
        print(f"real engine: TTFT {r['ttft_mean']*1e3:.0f}ms "
              f"hit {r['block_hit_rate']:.1%} "
              f"worst-abs-err {out['worst_abs_err']:.2e}")
        return 0
    print(f"{'policy':<12} {'TTFT(s)':>8} {'TPOT(ms)':>9} {'hit':>6} "
          f"{'evictions':>9}")
    for policy, r in run_sim(a.sessions).items():
        print(f"{policy:<12} {r['ttft_mean']:>8.2f} "
              f"{r['tpot_mean']*1e3:>9.2f} {r['block_hit_rate']:>6.1%} "
              f"{r['evictions']:>9}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
