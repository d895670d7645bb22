"""Request / session model for the serving runtime.

Outputs are *scripted* (teacher-forced): the paper fixes output tokens by
rewriting each decoded token so runs are deterministic and comparable; we
do the same by forcing the scripted token after computing real logits —
the compute (and therefore every latency and every KV value) is identical
to sampling, but runs are reproducible and losslessness is checkable.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class RequestState(enum.Enum):
    WAITING = 0
    PREFILL = 1
    DECODE = 2
    FINISHED = 3
    # aborted by the client (online frontend): blocks released immediately,
    # no stats recorded, the request never re-enters scheduling
    CANCELLED = 4
    # terminal fault domain (docs/SERVING.md "Failure semantics"):
    # FAILED  — the request's own machinery faulted (throwing on_token
    #           callback, deadline exceeded); everything it owned is
    #           released and the loop keeps serving everyone else
    # REJECTED — refused at admission with a structured reason
    #           (``Request.failure``): e.g. it can never fit the pool
    FAILED = 5
    REJECTED = 6


#: states a request can never leave (scheduling ignores them)
TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.CANCELLED,
    RequestState.FAILED, RequestState.REJECTED,
})


@dataclass
class Request:
    rid: int
    session_id: int
    prompt_tokens: List[int]
    output_script: List[int]          # forced output tokens
    arrival: float
    # agentic metadata (Continuum integration)
    is_tool_call: bool = False        # output ends in a tool call
    tool_duration: float = 0.0        # estimated tool execution time (TTL)
    # chain-hash namespace: 0 shares blocks across requests; any other
    # value isolates this request (the no-prefix-sharing baseline)
    hash_salt: int = 0
    # tenant attribution for the content-addressed global prefix store:
    # quota charging and isolation accounting key on this (KV bytes are
    # still shared freely — only store *retention* is per-tenant)
    tenant: str = "default"
    # -- online-frontend metadata (closed-loop session serving) -------------
    # which turn of its session this request is (0 = first); resumed marks
    # turns that follow a tool-call suspension — their demand swap-ins are
    # the "resume-time swap-in stalls" predictive prefetch must eliminate
    turn_index: int = 0
    resumed: bool = False
    # tool calls the session still has ahead of it INCLUDING this turn's;
    # the job-level fewest-remaining-calls-first admission policy sorts on
    # it (None = unknown -> FCFS ordering among unknowns)
    remaining_calls: Optional[int] = None
    # streaming callback ``fn(request, token_id)``, invoked once per
    # emitted output token (the teacher-forced token, at the step that
    # dispatched it — device-side greedy samples arrive one step later in
    # ``sampled_ids``).  May call ``AsymCacheServer.cancel`` to abort.
    # An exception escaping the callback is isolated to this request
    # (terminal ``failed`` status), never to the serve loop.
    on_token: Optional[object] = None
    # absolute-clock deadline: past it the server aborts the request
    # through the cancel machinery (terminal ``failed``/``deadline``)
    deadline: float = math.inf

    # -- runtime state ------------------------------------------------------
    state: RequestState = RequestState.WAITING
    block_slots: List[Optional[int]] = field(default_factory=list)
    hit_mask: List[bool] = field(default_factory=list)
    # logical positions to (re)compute; np.int32 array after admission so
    # step assembly can slice/index it without per-token Python loops
    compute_list: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))
    compute_ptr: int = 0
    generated: List[int] = field(default_factory=list)
    # device-side greedy samples (argmax token id) observed at each step
    # this request owned a selection row (prefill completion + every
    # decode).  Outputs stay teacher-forced; these are recorded for
    # pipelined-vs-synchronous equivalence checks and sampling stats.
    sampled_ids: List[int] = field(default_factory=list)
    # persistent step-assembly caches (engine-maintained): token ids as a
    # growing np.int32 array and the block->pool-slot map as np.int32
    _tok_arr: Optional[np.ndarray] = field(default=None, repr=False)
    _tok_len: int = field(default=0, repr=False)
    _slot_arr: Optional[np.ndarray] = field(default=None, repr=False)
    # positions computed this step whose logits we need (prefill completion)
    # -- metrics --------------------------------------------------------------
    admitted_at: float = math.nan
    first_token_at: float = math.nan
    finished_at: float = math.nan
    n_hit_blocks: int = 0
    n_total_blocks: int = 0
    n_swapped: int = 0        # host-tier blocks restored by swap-in
    prefix_len: int = 0       # tokens matched in the cross-request trie
    n_cow_forks: int = 0      # copy-on-write partial-block forks
    n_prefill_compute: int = 0  # prompt positions actually (re)computed
    # logits at prefill completion (losslessness validation)
    first_logits: Optional[object] = None
    # structured terminal-fault result: {"status": "failed"|"rejected",
    # "reason": ..., + site-specific fields such as required_blocks /
    # available_blocks}; None for every other outcome
    failure: Optional[Dict] = None

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def status(self) -> str:
        """Lowercase terminal/most-recent state name (the ``status``
        field of the structured per-request result)."""
        return self.state.name.lower()

    @property
    def all_tokens(self) -> List[int]:
        return self.prompt_tokens + self.generated

    # -- step-assembly caches ------------------------------------------------
    def token_array(self) -> np.ndarray:
        """``all_tokens`` as an np.int32 array, extended incrementally.

        The prompt is materialized once; each decode step appends O(1)
        amortized.  Valid data lives in ``[:prompt_len + len(generated)]``;
        callers index it by logical position."""
        n_prompt = len(self.prompt_tokens)
        n = n_prompt + len(self.generated)
        a = self._tok_arr
        if a is None:
            a = np.empty((max(self.target_len, n, 1),), np.int32)
            a[:n_prompt] = self.prompt_tokens
            self._tok_arr = a
            self._tok_len = n_prompt
        if a.shape[0] < n:
            grown = np.empty((max(2 * a.shape[0], n),), np.int32)
            grown[:self._tok_len] = a[:self._tok_len]
            self._tok_arr = a = grown
        if self._tok_len < n:
            a[self._tok_len:n] = self.generated[self._tok_len - n_prompt:]
            self._tok_len = n
        return a

    def slot_array(self) -> np.ndarray:
        """``block_slots`` as np.int32 (None -> 0), cached after admission.

        Blocks are allocated up-front in ``ChunkingScheduler._admit`` and
        never reassigned while the request runs, so this is built once per
        admission; ``reset_assembly_caches`` invalidates it."""
        a = self._slot_arr
        if a is None or a.shape[0] != len(self.block_slots):
            a = np.fromiter((0 if s is None else s for s in self.block_slots),
                            np.int32, len(self.block_slots))
            self._slot_arr = a
        return a

    def reset_assembly_caches(self) -> None:
        self._tok_arr = None
        self._tok_len = 0
        self._slot_arr = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def target_len(self) -> int:
        return len(self.prompt_tokens) + len(self.output_script)

    @property
    def prefill_done(self) -> bool:
        return self.compute_ptr >= len(self.compute_list)

    @property
    def decode_done(self) -> bool:
        return len(self.generated) >= len(self.output_script)

    # -- metrics helpers -----------------------------------------------------
    @property
    def ttft(self) -> float:
        return self.first_token_at - self.arrival

    @property
    def tpot(self) -> float:
        n = max(len(self.generated) - 1, 1)
        return (self.finished_at - self.first_token_at) / n

    @property
    def job_latency(self) -> float:
        return self.finished_at - self.arrival


@dataclass
class SessionStats:
    """Aggregated per-run metrics."""
    ttfts: List[float] = field(default_factory=list)
    tpots: List[float] = field(default_factory=list)
    job_latencies: List[float] = field(default_factory=list)
    request_hits: int = 0
    request_lookups: int = 0
    block_hits: int = 0
    block_lookups: int = 0
    prefill_compute_tokens: int = 0   # prompt positions actually computed
    prompt_tokens: int = 0            # prompt positions submitted
    prefix_matched_tokens: int = 0    # cross-request trie matches
    cow_forks: int = 0

    def record(self, req: Request) -> None:
        self.ttfts.append(req.ttft)
        self.tpots.append(req.tpot)
        self.job_latencies.append(req.job_latency)
        self.block_hits += req.n_hit_blocks
        self.block_lookups += req.n_total_blocks
        self.request_lookups += 1
        if req.n_hit_blocks > 0:
            self.request_hits += 1
        self.prefill_compute_tokens += req.n_prefill_compute
        self.prompt_tokens += req.prompt_len
        self.prefix_matched_tokens += req.prefix_len
        self.cow_forks += req.n_cow_forks

    def summary(self) -> Dict[str, float]:
        import numpy as np
        def _mean(xs):
            return float(np.mean(xs)) if xs else float("nan")
        def _p(xs, q):
            return float(np.percentile(xs, q)) if xs else float("nan")
        return {
            "n_requests": len(self.ttfts),
            "ttft_mean": _mean(self.ttfts),
            "ttft_p90": _p(self.ttfts, 90),
            "tpot_mean": _mean(self.tpots),
            "tpot_p90": _p(self.tpots, 90),
            "job_latency_mean": _mean(self.job_latencies),
            "job_latency_p90": _p(self.job_latencies, 90),
            "block_hit_rate": self.block_hits / max(self.block_lookups, 1),
            "request_hit_rate": self.request_hits / max(self.request_lookups, 1),
            "prefill_compute_tokens": self.prefill_compute_tokens,
            "prompt_tokens": self.prompt_tokens,
            "prefix_matched_tokens": self.prefix_matched_tokens,
            "cow_forks": self.cow_forks,
            "prefill_savings": 1.0 - self.prefill_compute_tokens
            / max(self.prompt_tokens, 1),
        }
