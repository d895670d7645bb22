"""Continuum-style session layer for online agent serving (paper §5.2 /
§6.5 / §8: "seamless integration into agent serving systems such as
Continuum").

An :class:`AgentSession` is the runtime of one agent *job*: a sequence of
model turns separated by tool executions.  Its lifecycle is the state
machine documented in ``docs/SERVING.md``:

    QUEUED → RUNNING → (SUSPENDED → PREFETCHING? → RUNNING)* → FINISHED
                  └────────────────── CANCELLED ──────────────────┘

Closed-loop semantics: the session's next turn is *generated* — the tool
starts when the previous turn's last token is emitted, and the next turn
arrives ``actual_duration`` later.  Nothing about the next arrival is
known to the server until the previous turn actually finishes, which is
what the paper's scripted ``agentic_workload`` replay (arrivals
precomputed as ``announced + 0.05``) could never exercise.

While SUSPENDED the session's KV blocks hold no references: they are
boosted (§5.2 correction factor) but *swap-out eligible* — under memory
pressure the evictor may spill them to the host tier.  The frontend turns
the announced tool duration into a predicted resume
(:class:`repro_torch.core.lifespan.ResumePredictor`) and calls
``BlockManager.prefetch`` ahead of it, which restores the blocks to the
device and TTL-pins them so the resumed turn admits with zero demand
swap-ins ("resume-time swap-in stalls").
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.workload import SessionScript, TurnScript


class SessionState(enum.Enum):
    QUEUED = 0        # first turn not yet submitted
    RUNNING = 1       # a turn is waiting/prefilling/decoding
    SUSPENDED = 2     # tool executing; KV released, swap-out eligible
    PREFETCHING = 3   # predictive restore issued, resume pin in force
    FINISHED = 4
    CANCELLED = 5
    # terminal fault domain: the session's in-flight turn FAILED or was
    # REJECTED (see RequestState) — the job is over, everything released
    FAILED = 6


class AgentSession:
    """Runtime state of one closed-loop agent job over a SessionScript."""

    def __init__(self, script: SessionScript):
        self.script = script
        self.state = SessionState.QUEUED
        self.turn_idx = -1                    # last issued turn
        self.history: List[int] = list(script.history0)
        self.requests: List[Request] = []
        # tokens whose KV the session has actually computed (prompt +
        # output of every finished turn) — the prefetchable content; the
        # tool result of the pending turn is NOT in it (never computed)
        self.computed_tokens: List[int] = []
        self.suspended_at = math.nan
        self.resume_at = math.nan             # actual (closed-loop) resume
        self.predicted_resume_at = math.nan
        self.finished_at = math.nan

    # ------------------------------------------------------------------
    @property
    def sid(self) -> int:
        return self.script.sid

    @property
    def current(self) -> Optional[Request]:
        return self.requests[-1] if self.requests else None

    @property
    def turns_left(self) -> int:
        return len(self.script.turns) - (self.turn_idx + 1)

    @property
    def remaining_calls(self) -> int:
        """Tool calls in this and future turns (the job-level admission
        key: fewest-remaining-calls-first)."""
        return sum(1 for t in self.script.turns[max(self.turn_idx, 0):]
                   if t.is_tool)

    @property
    def job_latency(self) -> float:
        return self.finished_at - self.script.arrival

    # ------------------------------------------------------------------
    def make_request(self, rid: int, arrival: float,
                     on_token=None) -> Request:
        """Materialize the session's next turn as a Request.  The prompt
        is the full conversation history — identical, token for token, to
        what the scripted replay would have submitted for this turn."""
        assert self.turns_left > 0 and self.state in (
            SessionState.QUEUED, SessionState.SUSPENDED,
            SessionState.PREFETCHING)
        self.turn_idx += 1
        turn = self.script.turns[self.turn_idx]
        req = Request(
            rid=rid, session_id=self.sid,
            prompt_tokens=list(self.history),
            output_script=list(turn.output), arrival=arrival,
            is_tool_call=turn.is_tool, tool_duration=turn.tool_duration,
            turn_index=self.turn_idx, resumed=self.turn_idx > 0,
            remaining_calls=self.remaining_calls, on_token=on_token)
        self.requests.append(req)
        self.state = SessionState.RUNNING
        return req

    def finish_turn(self, now: float) -> TurnScript:
        """Advance the session past its just-finished turn: extend the
        history with output + tool result, update the computed-token
        snapshot, and transition to SUSPENDED (tool pending) or FINISHED.
        Returns the finished TurnScript (its ``actual_duration`` is when
        the closed-loop resume fires)."""
        turn = self.script.turns[self.turn_idx]
        self.computed_tokens = self.history + turn.output
        self.history = self.computed_tokens + turn.tool_result
        if self.turns_left == 0:
            self.state = SessionState.FINISHED
            self.finished_at = now
        else:
            self.state = SessionState.SUSPENDED
            self.suspended_at = now
            self.resume_at = now + turn.actual_duration
        return turn

    def cancel(self, now: float) -> None:
        self.state = SessionState.CANCELLED
        self.finished_at = now

    def fail(self, now: float) -> None:
        self.state = SessionState.FAILED
        self.finished_at = now


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolation percentile that never raises: ``nan`` for an
    empty sample, the value itself for a singleton.  The stress benchmark
    reports warm-up slices that may hold zero or one observation, so this
    must stay total."""
    if not xs:
        return float("nan")
    ys = sorted(float(x) for x in xs)
    if len(ys) == 1:
        return ys[0]
    q = min(max(float(q), 0.0), 100.0)
    pos = (len(ys) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (pos - lo)


def mean(xs: List[float]) -> float:
    """Arithmetic mean; ``nan`` for an empty sample (never raises)."""
    return sum(float(x) for x in xs) / len(xs) if xs else float("nan")


# short internal aliases used by the summary tables below
_pct = percentile
_mean = mean


@dataclass
class OnlineTelemetry:
    """Per-run online-serving metrics: turn-level TTFT/TPOT and job-level
    (whole-session) latency percentiles, plus the resume-path counters the
    prefetch benchmark gates on.  Scoped to one frontend run (the server's
    ``SessionStats`` accumulates across runs; this does not)."""
    ttfts: List[float] = field(default_factory=list)
    tpots: List[float] = field(default_factory=list)
    turn_latencies: List[float] = field(default_factory=list)
    job_latencies: List[float] = field(default_factory=list)
    resumed_turns: int = 0
    resume_swap_stalls: int = 0        # demand swap-ins at resume admission
    resumed_recompute_tokens: int = 0  # prompt positions recomputed on resume
    recompute_tokens: int = 0          # ... across all turns
    cancelled_turns: int = 0
    cancelled_jobs: int = 0
    failed_turns: int = 0         # on_token fault / deadline abort
    rejected_turns: int = 0       # structured admission rejection
    failed_jobs: int = 0

    def record_turn(self, req: Request) -> None:
        if req.state is RequestState.CANCELLED:
            self.cancelled_turns += 1
            return
        if req.state is RequestState.FAILED:
            self.failed_turns += 1
            return
        if req.state is RequestState.REJECTED:
            self.rejected_turns += 1
            return
        self.ttfts.append(req.ttft)
        self.tpots.append(req.tpot)
        self.turn_latencies.append(req.job_latency)
        self.recompute_tokens += req.n_prefill_compute
        if req.resumed:
            self.resumed_turns += 1
            self.resume_swap_stalls += req.n_swapped
            self.resumed_recompute_tokens += req.n_prefill_compute

    def record_job(self, session: AgentSession) -> None:
        if session.state is SessionState.CANCELLED:
            self.cancelled_jobs += 1
            return
        if session.state is SessionState.FAILED:
            self.failed_jobs += 1
            return
        self.job_latencies.append(session.job_latency)

    def summary(self) -> Dict[str, float]:
        return {
            "n_jobs": len(self.job_latencies),
            "n_turns": len(self.ttfts),
            "agent_job_latency_mean": _mean(self.job_latencies),
            "agent_job_latency_p50": _pct(self.job_latencies, 50),
            "agent_job_latency_p90": _pct(self.job_latencies, 90),
            "agent_job_latency_p99": _pct(self.job_latencies, 99),
            "online_ttft_mean": _mean(self.ttfts),
            "online_ttft_p90": _pct(self.ttfts, 90),
            "online_tpot_mean": _mean(self.tpots),
            "online_tpot_p90": _pct(self.tpots, 90),
            "turn_latency_p90": _pct(self.turn_latencies, 90),
            "resumed_turns": self.resumed_turns,
            "resume_swap_stalls": self.resume_swap_stalls,
            "resumed_recompute_tokens": self.resumed_recompute_tokens,
            "recompute_tokens": self.recompute_tokens,
            "cancelled_turns": self.cancelled_turns,
            "cancelled_jobs": self.cancelled_jobs,
            "failed_turns": self.failed_turns,
            "rejected_turns": self.rejected_turns,
            "failed_jobs": self.failed_jobs,
        }

    def window_summary(self, first_n: int) -> Dict[str, float]:
        """Percentiles over only the first ``first_n`` recorded turns — the
        stress benchmark's warm-up slice.  Safe for any ``first_n`` (empty
        and singleton windows report ``nan`` / the lone sample)."""
        n = max(0, int(first_n))
        return {
            "n_turns": min(n, len(self.ttfts)),
            "online_ttft_mean": mean(self.ttfts[:n]),
            "online_ttft_p90": percentile(self.ttfts[:n], 90),
            "online_tpot_p90": percentile(self.tpots[:n], 90),
            "turn_latency_p90": percentile(self.turn_latencies[:n], 90),
        }
