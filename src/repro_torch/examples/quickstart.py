"""Quickstart: serve a small model with AsymCache and verify losslessness.

Builds a reduced Llama-family model, runs a multi-turn workload through
the full stack (block manager -> computational-aware evictor -> adaptive
chunking scheduler -> MSA engine, one fused attention kernel launch a
layer a step), prints latency/hit metrics, and checks that every
request's logits match the dense no-cache reference.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.examples._smoke import (LOSSLESS_REL_TOL, device_ok,
                                         logit_errors, multi_turn_server,
                                         smoke_model)
from repro_torch.serving import WorkloadConfig, multi_turn_workload

WORKLOAD = WorkloadConfig(
    n_sessions=4, turns_per_session=(2, 3), first_ctx_len=(96, 200),
    output_len=(16, 40), qps=1.0, seed=0)
NUM_BLOCKS = 64


def run(cfg: Optional[ModelConfig] = None, params: Optional[Dict] = None,
        workload_cfg: WorkloadConfig = WORKLOAD, clock: str = "wall",
        device="cuda") -> Dict:
    """Serve ``workload_cfg``'s multi-turn requests over a 64-block pool:
    ``{"summary": the run's summary, "requests": the served requests,
    "worst_rel_err": their worst first-logit error against the dense
    reference}``."""
    cfg, params, dev = smoke_model(cfg, params, device)
    workload = multi_turn_workload(workload_cfg)
    result = multi_turn_server(cfg, params, dev, NUM_BLOCKS,
                               clock).run(workload)
    return {"summary": result, "requests": workload,
            "worst_rel_err": logit_errors(cfg, params, workload)[0]}


def main(argv=None) -> int:
    prog = "python -m repro_torch.examples.quickstart"
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda, cuda:<i> or cpu")
    args = ap.parse_args(argv)
    if not device_ok(args.device, prog):
        return 2
    out = run(device=args.device)
    workload, result = out["requests"], out["summary"]
    print(f"workload: {len(workload)} requests, "
          f"max prompt {max(len(r.prompt_tokens) for r in workload)} tokens")
    print(f"TTFT mean {result['ttft_mean']*1e3:.1f} ms | "
          f"TPOT mean {result['tpot_mean']*1e3:.2f} ms | "
          f"block hit rate {result['block_hit_rate']:.1%} | "
          f"evictions {result['evictions']}")
    worst = out["worst_rel_err"]
    print(f"losslessness: worst relative logits error vs dense reference "
          f"= {worst:.2e}")
    assert worst < LOSSLESS_REL_TOL
    print("OK — eviction + multi-segment recomputation is exact.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
