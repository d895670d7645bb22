"""Online session serving quickstart: closed-loop agent jobs with
streaming tokens, suspend/resume, and predictive host-tier prefetch.

Five tool-calling agent jobs run CLOSED-LOOP through the real engine:
each next turn is generated when the previous turn's last token is
emitted plus the tool's actual duration — nothing is pre-scripted about
*when* turns happen.  When a turn ends in a tool call the session
suspends (its KV blocks may spill to the host tier under pressure); the
lifespan predictor schedules a prefetch just before the predicted resume
so the resumed turn admits with zero demand swap-ins.

One job is cancelled mid-decode from its streaming callback to
demonstrate the abort path (its blocks are released immediately).

    PYTHONPATH=src python -m repro_torch.examples.serve_online [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.examples._smoke import device_ok, smoke_model
from repro_torch.serving import (
    AgenticConfig,
    AsymCacheServer,
    EngineConfig,
    FrontendConfig,
    OnlineFrontend,
    SchedulerConfig,
    ServerConfig,
    agentic_session_scripts,
)

CANCEL_SID = 4          # job aborted after its 5th streamed token
CANCEL_AFTER = 5
NUM_BLOCKS, HOST_BLOCKS = 40, 24
JOBS = AgenticConfig(
    n_jobs=5, tool_calls_per_job=(2, 3), system_prefix_len=32,
    task_len=(32, 64), tool_result_len=(16, 48), output_len=(12, 24),
    tool_duration=(0.6, 1.5), qps=1.5, seed=7)


def run(cfg: Optional[ModelConfig] = None, params: Optional[Dict] = None,
        jobs: AgenticConfig = JOBS, cancel_sid: int = CANCEL_SID,
        device="cuda") -> Dict:
    """Serve ``jobs`` through the online frontend with prefetch on the
    model clock, cancelling job ``cancel_sid`` after its 5th streamed
    token: ``{"summary": the frontend's run summary, "sessions": [(sid,
    turns, state name, job latency)], "streamed": {sid: tokens},
    "cancelled_after": tokens streamed when the cancel was issued (None
    if never), "released": every block reference released}``."""
    cfg, params, dev = smoke_model(cfg, params, device)
    scripts = agentic_session_scripts(jobs)
    srv = AsymCacheServer(cfg, params, ServerConfig(
        policy="asymcache", num_blocks=NUM_BLOCKS, block_size=16,
        clock="model", host_blocks=HOST_BLOCKS,
        scheduler=SchedulerConfig(token_budget=160, max_chunk=96,
                                  max_prefills=2, max_decodes=8)),
        ecfg=EngineConfig(num_pages=NUM_BLOCKS, page_size=16,
                          max_prefills=2, max_chunk=96, max_decodes=8,
                          max_blocks_per_seq=32),
        device=dev)

    streamed, cancelled = {}, []

    def on_token(req, tok):
        streamed[req.session_id] = streamed.get(req.session_id, 0) + 1
        if req.session_id == cancel_sid \
                and streamed[cancel_sid] == CANCEL_AFTER:
            cancelled.append(streamed[cancel_sid])
            fe.cancel_session(cancel_sid)

    fe = OnlineFrontend(srv, scripts, FrontendConfig(prefetch=True),
                        on_token=on_token)
    res = fe.run()
    return {"summary": res,
            "sessions": [(s.sid, len(s.requests), s.state.name,
                          s.job_latency) for s in fe.sessions],
            "streamed": dict(sorted(streamed.items())),
            "cancelled_after": cancelled[0] if cancelled else None,
            "released": all(b.ref_count == 0 for b in srv.bm.blocks)}


def main(argv=None) -> int:
    prog = "python -m repro_torch.examples.serve_online"
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda, cuda:<i> or cpu")
    args = ap.parse_args(argv)
    if not device_ok(args.device, prog):
        return 2
    out = run(device=args.device)
    res = out["summary"]
    if out["cancelled_after"] is not None:
        print(f"  [job {CANCEL_SID}] cancelling mid-decode "
              f"(after {out['cancelled_after']} streamed tokens)")

    print(f"\n{'job':>4} {'turns':>6} {'state':<10} {'latency(s)':>10}")
    for sid, turns, state, lat in out["sessions"]:
        print(f"{sid:>4} {turns:>6} {state:<10} "
              + (f"{lat:>10.2f}" if lat == lat else f"{'—':>10}"))

    print(f"\nstreamed tokens/job: {out['streamed']}")
    print(f"job latency mean/p90: {res['agent_job_latency_mean']:.2f}s / "
          f"{res['agent_job_latency_p90']:.2f}s")
    print(f"prefetch: {res['prefetch_swap_ins']} host->device restores, "
          f"{res['prefetch_pins']} pins, {res['prefetch_hits']} hits")
    print(f"resume-time swap-in stalls: {res['resume_swap_stalls']}")

    # refcount hygiene: everything (including the cancelled job's blocks)
    # is released by the end of the run
    assert out["released"]
    assert res["resume_swap_stalls"] == 0, "prefetch should cover resumes"
    print("\nall block references released; zero resume stalls — OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
