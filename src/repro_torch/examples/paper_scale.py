"""Paper-scale discrete-event servers and workloads for the examples
(a copy of the helpers ``benchmarks/common.py`` gives the JAX package's
examples, over ``repro_torch``, cut to what the examples use).

The servers run the real block manager, evictor and scheduler with no
model: step times come from the Eq.-6 analytic cost model on the
paper's H20 constants, so a run equals the reference's to the bit.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import get_config
from repro_torch.core import H20, analytic_cost_model
from repro_torch.serving import (
    AgenticConfig,
    AsymCacheServer,
    SchedulerConfig,
    ServerConfig,
    WorkloadConfig,
    agentic_workload,
    multi_turn_workload,
)

BLOCK_SIZE = 16


def longbench_like(n_sessions: int, qps: float, intra_ratio: float,
                   seed: int = 0) -> List:
    """Multi-turn QA over long docs (paper: avg in 34.8K / out 2.6K),
    at the reference's scaled-down lengths."""
    return multi_turn_workload(WorkloadConfig(
        n_sessions=n_sessions, turns_per_session=(2, 5),
        system_prefix_len=512, first_ctx_len=(6_000, 16_000),
        user_len=(64, 512), output_len=(300, 900), vocab=50_000,
        qps=qps, cv=0.25, intra_ratio=intra_ratio, seed=seed))


def bfcl_like(n_jobs: int, qps: float, seed: int = 0) -> List:
    """Agentic web-search-like tool-calling jobs (BFCL v4 style)."""
    return agentic_workload(AgenticConfig(
        n_jobs=n_jobs, tool_calls_per_job=(2, 6),
        system_prefix_len=384, task_len=(512, 2_048),
        tool_result_len=(256, 2_048), output_len=(96, 384),
        tool_duration=(0.3, 1.5), vocab=50_000, qps=qps, seed=seed))


def workload_footprint(requests) -> int:
    """Unique-token cache demand: per session, the final history length."""
    per_session: Dict[int, int] = {}
    for r in requests:
        per_session[r.session_id] = max(
            per_session.get(r.session_id, 0),
            len(r.prompt_tokens) + len(r.output_script))
    return sum(per_session.values())


def pressured_server(policy: str, wl, pressure: float,
                     continuum: bool = False,
                     lifespan: float = 60.0) -> AsymCacheServer:
    """Discrete-event Llama-3.1-8B server whose cache is ``pressure`` x
    the workload footprint (at least 64 blocks) — the paper's
    memory-constrained regime (their 487K-token cache vs ~10M-token trace
    is ~5%) — with the Eq.-6 cost model on the paper's H20 hardware."""
    cfg = get_config("llama31-8b")
    cache_tokens = max(int(workload_footprint(wl) * pressure), 64 * BLOCK_SIZE)
    cm = analytic_cost_model(cfg, H20, n_chips=1)
    scfg = ServerConfig(
        policy=policy, num_blocks=cache_tokens // BLOCK_SIZE,
        block_size=BLOCK_SIZE, clock="model", execute_model=False,
        continuum_ttl=continuum, lifespan=lifespan,
        scheduler=SchedulerConfig(
            block_size=BLOCK_SIZE, token_budget=4096, max_prefills=4,
            max_chunk=2048, min_chunk=256, max_decodes=64,
            decode_threshold=8, max_running=48))
    return AsymCacheServer(cfg, None, scfg, cost_model=cm, sim_cost_model=cm)
