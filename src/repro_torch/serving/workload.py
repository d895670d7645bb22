"""Workload generators (paper §6.1): multi-turn conversation sessions with
Gamma arrivals, and agentic tool-calling sessions (BFCL-like).

Multi-turn: first-turn arrivals follow a Gamma process (CV 0.25); turn
intervals within a session follow another Gamma process.  The
inter:intra-session rate ratio controls *dispersion* — 5:1 "low" and
10:1 "high" per the paper.  Each turn's prompt = shared system prefix +
full conversation history + new user text; outputs are scripted.

Agentic: tool-call turns with short, predictable intervals
(tool_duration), deterministic continuation — the Continuum setting.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.serving.request import Request


@dataclass
class WorkloadConfig:
    n_sessions: int = 12
    turns_per_session: Tuple[int, int] = (2, 5)
    system_prefix_len: int = 64            # shared across ALL sessions
    first_ctx_len: Tuple[int, int] = (128, 512)   # per-session document
    user_len: Tuple[int, int] = (16, 64)
    output_len: Tuple[int, int] = (16, 96)
    vocab: int = 250
    # arrivals
    qps: float = 0.5                       # session arrival rate
    cv: float = 0.25                       # coefficient of variation
    intra_ratio: float = 5.0               # inter:intra arrival-rate ratio
    seed: int = 0


def _gamma_interval(rng: random.Random, rate: float, cv: float) -> float:
    """Sample an inter-arrival from a Gamma with mean 1/rate and given CV.

    ``cv=0`` is the deterministic limit (a Gamma's shape → ∞ as CV → 0):
    every interval is exactly the mean ``1/rate`` — the fixed-rate arrival
    process, useful for reproducible pacing experiments."""
    if cv <= 0.0:
        return 1.0 / rate
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (rate * shape)
    return rng.gammavariate(shape, scale)


def _tokens(rng: random.Random, n: int, vocab: int) -> List[int]:
    return [rng.randrange(2, vocab) for _ in range(n)]


def multi_turn_workload(cfg: WorkloadConfig) -> List[Request]:
    rng = random.Random(cfg.seed)
    system_prefix = _tokens(rng, cfg.system_prefix_len, cfg.vocab)
    requests: List[Request] = []
    rid = 0
    t = 0.0
    # inter:intra rate ratio (paper §6.1): higher ratio -> turns of one
    # session arrive RELATIVELY less often -> more foreign requests
    # interleave between consecutive turns -> higher dispersion
    intra_rate = cfg.qps / max(cfg.intra_ratio, 1e-9)
    for sid in range(cfg.n_sessions):
        t += _gamma_interval(rng, cfg.qps, cfg.cv)
        history = list(system_prefix) + _tokens(
            rng, rng.randint(*cfg.first_ctx_len), cfg.vocab)
        turn_time = t
        n_turns = rng.randint(*cfg.turns_per_session)
        for turn in range(n_turns):
            user = _tokens(rng, rng.randint(*cfg.user_len), cfg.vocab)
            output = _tokens(rng, rng.randint(*cfg.output_len), cfg.vocab)
            prompt = history + user
            requests.append(Request(
                rid=rid, session_id=sid, prompt_tokens=prompt,
                output_script=output, arrival=turn_time))
            rid += 1
            history = prompt + output
            turn_time += _gamma_interval(rng, intra_rate, 1.0)
    requests.sort(key=lambda r: r.arrival)
    return requests


@dataclass
class AgenticConfig:
    n_jobs: int = 10
    tool_calls_per_job: Tuple[int, int] = (2, 5)
    system_prefix_len: int = 48
    task_len: Tuple[int, int] = (64, 192)
    tool_result_len: Tuple[int, int] = (32, 128)
    output_len: Tuple[int, int] = (24, 64)
    tool_duration: Tuple[float, float] = (0.5, 2.0)   # predictable, short
    # fractional deviation of the ACTUAL tool run from the announced
    # duration: actual = announced * (1 + U(-jitter, +jitter)).  0 = the
    # perfectly predictable tools of the Continuum setting; > 0 exercises
    # the ResumePredictor's error correction (closed-loop frontend only —
    # the scripted replay always paces by the announced duration).
    tool_jitter: float = 0.0
    vocab: int = 250
    qps: float = 0.5
    seed: int = 0


@dataclass
class TurnScript:
    """One scripted model turn of an agent job: the forced output tokens,
    the tool result appended to the history afterwards, and the tool
    timing.  ``tool_duration`` is what the job ANNOUNCES (the Continuum
    TTL estimate); ``actual_duration`` is how long the tool really runs —
    the closed-loop frontend resumes the session ``actual_duration`` after
    the turn's last token, whereas the scripted replay paces by the
    announced value."""
    output: List[int]
    tool_result: List[int]
    is_tool: bool
    tool_duration: float
    actual_duration: float


@dataclass
class SessionScript:
    """Deterministic description of one agent job: the initial context and
    the full turn sequence.  The SAME scripts drive both execution modes —
    the offline scripted replay (:func:`requests_from_scripts`) and the
    closed-loop online frontend (`repro.serving.frontend`) — which is what
    makes the two byte-comparable per turn."""
    sid: int
    arrival: float
    history0: List[int]
    turns: List[TurnScript]

    @property
    def n_tool_calls(self) -> int:
        return sum(1 for t in self.turns if t.is_tool)


def agentic_session_scripts(cfg: AgenticConfig) -> List[SessionScript]:
    """Generate the token/timing scripts of an agentic workload.

    Draws from the RNG in exactly the order the original flat generator
    did, so a given seed keeps producing the identical workload.  Jitter
    (``cfg.tool_jitter``) is drawn from a SEPARATE stream so enabling it
    never perturbs the token content."""
    rng = random.Random(cfg.seed)
    jrng = random.Random((cfg.seed << 16) ^ 0x9E3779B9)
    system_prefix = _tokens(rng, cfg.system_prefix_len, cfg.vocab)
    scripts: List[SessionScript] = []
    t = 0.0
    for job in range(cfg.n_jobs):
        t += _gamma_interval(rng, cfg.qps, 0.25)
        history0 = list(system_prefix) + _tokens(
            rng, rng.randint(*cfg.task_len), cfg.vocab)
        turns: List[TurnScript] = []
        n_calls = rng.randint(*cfg.tool_calls_per_job)
        for call in range(n_calls + 1):
            is_tool = call < n_calls
            output = _tokens(rng, rng.randint(*cfg.output_len), cfg.vocab)
            tool_dur = rng.uniform(*cfg.tool_duration) if is_tool else 0.0
            result = _tokens(rng, rng.randint(*cfg.tool_result_len), cfg.vocab)
            actual = tool_dur
            if is_tool and cfg.tool_jitter > 0.0:
                actual = tool_dur * (
                    1.0 + jrng.uniform(-cfg.tool_jitter, cfg.tool_jitter))
            turns.append(TurnScript(output=output, tool_result=result,
                                    is_tool=is_tool, tool_duration=tool_dur,
                                    actual_duration=actual))
        scripts.append(SessionScript(sid=job, arrival=t, history0=history0,
                                     turns=turns))
    return scripts


def requests_from_scripts(scripts: List[SessionScript],
                          gap: float = 0.05) -> List[Request]:
    """Offline scripted replay of session scripts: every turn's arrival is
    precomputed as ``previous arrival + announced tool duration + gap`` —
    the OPEN-loop approximation the closed-loop frontend replaces (it
    ignores when the previous turn's generation actually finished)."""
    requests: List[Request] = []
    rid = 0
    for s in scripts:
        history = list(s.history0)
        turn_time = s.arrival
        for turn in s.turns:
            requests.append(Request(
                rid=rid, session_id=s.sid, prompt_tokens=list(history),
                output_script=list(turn.output), arrival=turn_time,
                is_tool_call=turn.is_tool, tool_duration=turn.tool_duration))
            rid += 1
            history = history + turn.output + turn.tool_result
            turn_time += turn.tool_duration + gap  # tool latency dominates
    requests.sort(key=lambda r: r.arrival)
    return requests


def agentic_workload(cfg: AgenticConfig) -> List[Request]:
    """Tool-calling jobs: each model turn emits a tool call; the tool runs
    for a short deterministic duration, then the next turn arrives with
    history + tool result appended.  (Scripted replay of
    :func:`agentic_session_scripts`; serve the same scripts closed-loop
    with `repro.serving.frontend.OnlineFrontend`.)"""
    return requests_from_scripts(agentic_session_scripts(cfg))


@dataclass
class StressConfig:
    """Control-plane stress workload: thousands of short
    agentic sessions arriving in bursts so the resident-session count —
    not the model math — is what the run exercises.  Prompts are short
    and outputs long relative to them (decode-dominated), every session
    has exactly ``turns_per_session`` turns, and tool durations are long
    enough that most sessions sit SUSPENDED (pinned/host-resident)
    between turns.  Run under ``clock="model"`` so the per-step
    control-plane op counters are deterministic."""
    n_sessions: int = 5000
    turns_per_session: int = 2
    system_prefix_len: int = 32            # shared across all sessions
    task_len: Tuple[int, int] = (8, 24)    # short unique context
    output_len: Tuple[int, int] = (24, 48) # decode-heavy
    tool_result_len: Tuple[int, int] = (4, 12)
    tool_duration: Tuple[float, float] = (4.0, 12.0)
    burst_size: int = 64                   # sessions per arrival burst
    burst_gap: float = 0.25                # model-seconds between bursts
    vocab: int = 250
    seed: int = 0


def control_plane_stress_scripts(cfg: StressConfig) -> List[SessionScript]:
    """Session scripts for the 5–10k-session control-plane stress run.

    Arrivals come in bursts of ``burst_size`` sessions at the same
    instant (worst case for the frontend event heap and the scheduler's
    waiting queue), and the long announced tool durations keep a large
    suspended population resident in the block manager / evictor while
    the active set decodes."""
    rng = random.Random(cfg.seed)
    system_prefix = _tokens(rng, cfg.system_prefix_len, cfg.vocab)
    scripts: List[SessionScript] = []
    for sid in range(cfg.n_sessions):
        arrival = (sid // cfg.burst_size) * cfg.burst_gap
        history0 = list(system_prefix) + _tokens(
            rng, rng.randint(*cfg.task_len), cfg.vocab)
        turns: List[TurnScript] = []
        for turn in range(cfg.turns_per_session):
            is_tool = turn < cfg.turns_per_session - 1
            output = _tokens(rng, rng.randint(*cfg.output_len), cfg.vocab)
            tool_dur = rng.uniform(*cfg.tool_duration) if is_tool else 0.0
            result = _tokens(rng, rng.randint(*cfg.tool_result_len),
                             cfg.vocab)
            turns.append(TurnScript(output=output, tool_result=result,
                                    is_tool=is_tool, tool_duration=tool_dur,
                                    actual_duration=tool_dur))
        scripts.append(SessionScript(sid=sid, arrival=arrival,
                                     history0=history0, turns=turns))
    return scripts


def decode_burst_workload(n_requests: int = 8,
                          prompt_len: Tuple[int, int] = (24, 48),
                          output_len: Tuple[int, int] = (33, 48),
                          vocab: int = 250,
                          seed: int = 0) -> List[Request]:
    """All-at-once single-turn batch for the multi-token decode dispatch
    equivalence check: every request arrives at t=0, prompts are short
    (prefill drains in one or two steps) and output lengths straddle
    non-multiples of the k bucket so per-request early exit + host-side
    rollback of unconsumed iterations is exercised."""
    rng = random.Random(seed)
    requests: List[Request] = []
    lens = list(range(output_len[0], output_len[1] + 1))
    for rid in range(n_requests):
        prompt = _tokens(rng, rng.randint(*prompt_len), vocab)
        out = _tokens(rng, lens[rid % len(lens)], vocab)
        requests.append(Request(rid=rid, session_id=rid,
                                prompt_tokens=prompt, output_script=out,
                                arrival=0.0))
    return requests


@dataclass
class SharedPrefixConfig:
    """Single-turn agentic jobs where most prompts lead with one long
    shared system-prompt + tool-preamble block — the Continuum fleet
    setting (paper §8) that cross-request prefix sharing targets.

    ``shared_fraction`` of the jobs use the common preamble; the rest are
    unrelated one-off prompts.  The preamble length deliberately defaults
    to a non-multiple of the block size so the partial-block
    copy-on-write path is exercised, not just full-block sharing."""
    n_jobs: int = 16
    shared_fraction: float = 0.75          # jobs using the common preamble
    system_prefix_len: int = 200           # NOT a block multiple (16) on purpose
    task_len: Tuple[int, int] = (32, 96)   # per-job unique suffix
    output_len: Tuple[int, int] = (8, 24)
    vocab: int = 250
    qps: float = 2.0
    seed: int = 0
    # round-robin tenant attribution (prefix-store quota accounting);
    # 1 leaves every request on the "default" tenant
    tenants: int = 1


def shared_prefix_workload(cfg: SharedPrefixConfig) -> List[Request]:
    rng = random.Random(cfg.seed)
    system_prefix = _tokens(rng, cfg.system_prefix_len, cfg.vocab)
    requests: List[Request] = []
    t = 0.0
    for rid in range(cfg.n_jobs):
        t += _gamma_interval(rng, cfg.qps, 0.25)
        task = _tokens(rng, rng.randint(*cfg.task_len), cfg.vocab)
        if rng.random() < cfg.shared_fraction:
            prompt = list(system_prefix) + task
        else:
            prompt = _tokens(rng, cfg.system_prefix_len // 2, cfg.vocab) + task
        requests.append(Request(
            rid=rid, session_id=rid, prompt_tokens=prompt,
            output_script=_tokens(rng, rng.randint(*cfg.output_len),
                                  cfg.vocab),
            arrival=t,
            tenant=("default" if cfg.tenants <= 1
                    else f"tenant{rid % cfg.tenants}")))
    return requests
