"""Cross-request prefix sharing on a shared-system-prompt agent fleet.

Most requests lead with the same system prompt + tool preamble.  With
prefix sharing on, the radix trie matches each new prompt against every
previously served sequence: full shared blocks are mapped straight into
the new request's page table (refcounted, unevictable while mapped), the
partial block at the divergence point is forked copy-on-write, and the
prefill computes only the unique suffix.

    PYTHONPATH=src python -m repro_torch.examples.prefix_sharing [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.examples._smoke import (LOSSLESS_REL_TOL, device_ok,
                                         logit_errors, smoke_model)
from repro_torch.serving import (
    AsymCacheServer,
    SchedulerConfig,
    ServerConfig,
    SharedPrefixConfig,
    shared_prefix_workload,
)

WORKLOAD = SharedPrefixConfig(n_jobs=10, shared_fraction=0.8,
                              system_prefix_len=280, qps=0.8, seed=3)
NUM_BLOCKS = 320


def run(cfg: Optional[ModelConfig] = None, params: Optional[Dict] = None,
        workload_cfg: SharedPrefixConfig = WORKLOAD, clock: str = "wall",
        device="cuda") -> Dict:
    """Serve ``workload_cfg``'s jobs with prefix sharing on, then off,
    over a 320-block pool: ``{"shared", "baseline": each arm's run
    summary, "requests", "baseline_requests": each arm's requests,
    "worst_rel_err": the sharing arm's worst first-logit error against
    the dense reference}``."""
    cfg, params, dev = smoke_model(cfg, params, device)

    def serve(sharing):
        wl = shared_prefix_workload(workload_cfg)
        srv = AsymCacheServer(cfg, params, ServerConfig(
            policy="asymcache", num_blocks=NUM_BLOCKS, block_size=16,
            clock=clock, prefix_sharing=sharing,
            scheduler=SchedulerConfig(token_budget=256, max_chunk=128,
                                      max_prefills=2, max_decodes=8)),
            device=dev)
        return wl, srv.run(wl)

    wl, res = serve(True)
    base_wl, base = serve(False)
    return {"shared": res, "baseline": base, "requests": wl,
            "baseline_requests": base_wl,
            "worst_rel_err": logit_errors(cfg, params, wl)[0]}


def main(argv=None) -> int:
    prog = "python -m repro_torch.examples.prefix_sharing"
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda, cuda:<i> or cpu")
    args = ap.parse_args(argv)
    if not device_ok(args.device, prog):
        return 2
    out = run(device=args.device)
    wl, res, base = out["requests"], out["shared"], out["baseline"]
    print(f"{len(wl)} requests, {WORKLOAD.system_prefix_len}-token shared "
          f"preamble ({WORKLOAD.shared_fraction:.0%} of jobs)")
    print(f"prefill tokens computed: {res['prefill_compute_tokens']} shared "
          f"vs {base['prefill_compute_tokens']} baseline "
          f"({base['prefill_compute_tokens']/res['prefill_compute_tokens']:.2f}x"
          f" reduction)")
    print(f"trie-matched prefix tokens: {res['prefix_matched_tokens']} | "
          f"copy-on-write forks: {res['cow_forks']} | "
          f"block hit rate: {res['block_hit_rate']:.1%}")
    worst = out["worst_rel_err"]
    print(f"losslessness: worst relative logits error = {worst:.2e}")
    assert worst < LOSSLESS_REL_TOL
    print("OK — shared prefixes served from cache, outputs exact.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
