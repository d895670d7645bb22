"""Online (closed-loop) session-serving frontend — the Continuum
integration the paper's §6.5/§8 agent-serving claim rests on.

The scripted replay (`AsymCacheServer.run`) knows every arrival up front:
``agentic_workload`` precomputes each turn's arrival as *previous arrival
+ announced tool duration + 0.05*, regardless of when generation actually
finished.  :class:`OnlineFrontend` closes the loop instead: it implements
the server's request-source protocol (``pop_due`` / ``next_time`` /
``done``) over an event heap, and a session's next tool-call turn is
*generated* ``actual_duration`` after the previous turn's **last token
was emitted** — the server's ``_finish`` listener is the only place the
next arrival can come from.

Per finished tool-call turn the frontend:

  1. transitions the session to SUSPENDED: its blocks hold no references
     (swap-out eligible under pressure) but carry the §5.2 tool boost so
     the evictor prefers other victims;
  2. asks the :class:`~repro_torch.core.lifespan.ResumePredictor` when the
     session will resume and schedules a **prefetch event**
     ``prefetch_lead`` before that: ``BlockManager.prefetch`` restores
     the session's computed blocks from the host tier (queued into the
     engine's in-step swap bucket) and TTL-pins them through the resume —
     so the resumed turn admits with *zero* demand swap-ins on the decode
     path;
  3. schedules the **resume arrival** at the actual tool completion.

Streaming and cancellation: each request carries an ``on_token`` callback
(fired once per emitted output token), and ``cancel_session`` aborts a
job at any point — mid-decode cancellation releases every block reference
immediately (refcounts return to the pre-admission baseline).

Telemetry: per-turn TTFT/TPOT and whole-job latency percentiles
(:class:`~repro_torch.serving.sessions.OnlineTelemetry`) plus the deterministic
prefetch/stall counters ``benchmarks/agentic_online.py`` gates on.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.lifespan import ResumePredictor
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.server import AsymCacheServer
from repro_torch.serving.sessions import (
    AgentSession,
    OnlineTelemetry,
    SessionState,
)
from repro_torch.serving.workload import SessionScript

#: session states past which no event for the session may fire
_TERMINAL = (SessionState.FINISHED, SessionState.CANCELLED,
             SessionState.FAILED)


@dataclass
class FrontendConfig:
    # predictive host-tier prefetch of suspended sessions' KV blocks
    prefetch: bool = True
    # fire the prefetch this many seconds before the predicted resume.
    # Larger leads widen the window in which the blocks are safe from the
    # host LRU but hold device memory longer; with perfectly predictable
    # tools anything > 0 suffices for zero resume stalls.
    prefetch_lead: float = 0.3
    # resume pin TTL past the predicted resume (covers prediction error;
    # the pin expires on this short TTL — or is dropped early by
    # cancel_session — so a generous grace bounds, not leaks, memory)
    pin_grace: float = 1.0
    # job-level admission arbitration: "fewest-remaining" (Continuum's
    # shortest-remaining-job-first over sessions) or "fcfs"
    admission: str = "fewest-remaining"


class OnlineFrontend:
    """Closed-loop request source + session manager over one server."""

    def __init__(self, server: AsymCacheServer,
                 scripts: List[SessionScript],
                 fcfg: Optional[FrontendConfig] = None,
                 on_token=None,
                 predictor: Optional[ResumePredictor] = None):
        self.server = server
        self.fcfg = fcfg or FrontendConfig()
        if self.fcfg.prefetch and not server.scfg.prefix_sharing:
            # prefetch resolves a RESUMED request's blocks through the
            # shared chain-hash namespace; private per-rid salts
            # (prefix_sharing=False) can never match across turns
            raise ValueError("prefetch requires prefix_sharing=True")
        self.predictor = predictor or ResumePredictor()
        self.on_token = on_token
        self.sessions = [AgentSession(s) for s in scripts]
        self._by_sid = {s.sid: s for s in self.sessions}
        assert len(self._by_sid) == len(self.sessions), "duplicate sids"
        self.telemetry = OnlineTelemetry()
        # (when, seq, kind, session, turn): seq breaks time ties
        # deterministically; turn tags a prefetch event with the
        # suspension it serves, so a stale event from an earlier,
        # mispredicted suspension can never fire for a later one
        self._heap: List[Tuple[float, int, str, AgentSession, int]] = []
        self._seq = 0
        self._next_rid = 0
        # event-heap pushes+pops — per scheduled step this must stay
        # sublinear in sessions (benchmarks/control_plane_stress.py)
        self.heap_ops = 0
        for s in self.sessions:
            self._push(s.script.arrival, "arrival", s)

    # -- event heap -----------------------------------------------------
    def _push(self, when: float, kind: str, sess: AgentSession,
              turn: int = -1) -> None:
        heapq.heappush(self._heap, (when, self._seq, kind, sess, turn))
        self._seq += 1
        self.heap_ops += 1

    def _prune(self) -> None:
        while self._heap and self._heap[0][3].state in _TERMINAL:
            heapq.heappop(self._heap)
            self.heap_ops += 1

    def _pf_due(self, sess: AgentSession, turn: int) -> bool:
        """A prefetch event is live only for the suspension it was
        scheduled by — same turn, still suspended."""
        return sess.state is SessionState.SUSPENDED \
            and sess.turn_idx == turn

    # -- RequestSource protocol (see server.ScriptedSource) -------------
    def pop_due(self, now: float) -> List[Request]:
        """Requests due by ``now``; fires due prefetch events on the way
        (a prefetch scheduled for the same instant as its resume pops
        first — its swap-ins are queued before the resume admits, and the
        in-step swap bucket lands them inside the very step that first
        reads the restored pages)."""
        out: List[Request] = []
        while self._heap and self._heap[0][0] <= now:
            when, _, kind, sess, turn = heapq.heappop(self._heap)
            self.heap_ops += 1
            if sess.state in _TERMINAL:
                continue
            if kind == "prefetch":
                if self._pf_due(sess, turn):
                    self._do_prefetch(sess, now)
            else:                                   # arrival
                if sess.turn_idx >= 0:
                    # the suspension is over: its actual duration is now
                    # observable — feed the predictor's error window
                    prev = sess.script.turns[sess.turn_idx]
                    self.predictor.observe(prev.actual_duration,
                                           prev.tool_duration)
                out.append(sess.make_request(
                    self._next_rid, arrival=when, on_token=self.on_token))
                self._next_rid += 1
        return out

    def next_time(self) -> Optional[float]:
        self._prune()
        return self._heap[0][0] if self._heap else None

    def done(self) -> bool:
        self._prune()
        return not self._heap

    # -- finish listener ------------------------------------------------
    def _on_finish(self, req: Request, now: float) -> None:
        sess = self._by_sid.get(req.session_id)
        if sess is None or sess.current is not req:
            return                       # not one of this frontend's turns
        turn = sess.finish_turn(now)
        self.telemetry.record_turn(req)
        if sess.state is SessionState.FINISHED:
            self.telemetry.record_job(sess)
            return
        # SUSPENDED: closed loop — the tool starts at the last emitted
        # token; the next turn arrives when it actually completes
        sess.predicted_resume_at = now + self.predictor.predict(
            turn.tool_duration)
        slots = [s for s in req.block_slots if s is not None]
        self.server.bm.set_boost(slots, self.server.scfg.tool_boost)
        if self.fcfg.prefetch:
            self._push(max(now, sess.predicted_resume_at
                           - self.fcfg.prefetch_lead), "prefetch", sess,
                       turn=sess.turn_idx)
        self._push(sess.resume_at, "arrival", sess)

    def _on_failure(self, req: Request, now: float) -> None:
        """Server-side terminal fault (FAILED/REJECTED): the server has
        already released every block the turn owned; the job is over.
        Pending heap events for the session are discarded lazily by
        ``_prune``/``pop_due`` exactly like a cancellation."""
        sess = self._by_sid.get(req.session_id)
        if sess is None or sess.current is not req:
            return                       # not one of this frontend's turns
        self.telemetry.record_turn(req)
        if self.fcfg.prefetch and sess.computed_tokens:
            self.server.bm.cancel_prefetch(
                self.server.bm.block_hashes(sess.computed_tokens),
                now, owner=sess.sid)
        sess.fail(now)
        self.telemetry.record_job(sess)

    def _do_prefetch(self, sess: AgentSession, now: float) -> None:
        sess.state = SessionState.PREFETCHING
        hashes = self.server.bm.block_hashes(sess.computed_tokens)
        self.server.bm.prefetch(
            hashes, now,
            until=sess.predicted_resume_at + self.fcfg.pin_grace,
            boost=self.server.scfg.tool_boost, owner=sess.sid)

    # -- public API -----------------------------------------------------
    def cancel_session(self, sid: int) -> bool:
        """Abort a job: cancels its in-flight turn (blocks released
        immediately), drops the resume pins of anything prefetched for
        it, and lazily discards its pending events."""
        sess = self._by_sid.get(sid)
        if sess is None or sess.state in _TERMINAL:
            return False
        req = sess.current
        # a suspended session's current request already finished (and was
        # recorded by _on_finish) — only record the turn the cancel
        # actually aborted
        if req is not None and self.server.cancel(req):
            self.telemetry.record_turn(req)
        if self.fcfg.prefetch and sess.computed_tokens:
            self.server.bm.cancel_prefetch(
                self.server.bm.block_hashes(sess.computed_tokens),
                self.server.now, owner=sess.sid)
        sess.cancel(self.server.now)
        self.telemetry.record_job(sess)
        return True

    def run(self, max_steps: int = 200_000) -> Dict:
        """Serve every session to completion; returns the server's run
        summary merged with the online telemetry.  The server's admission
        policy and pin-sweep flag are restored afterwards, so the same
        server can keep serving scripted workloads unchanged."""
        prev_admission = self.server.sched.cfg.admission
        prev_pins = self.server.uses_pins
        self.server.sched.cfg.admission = self.fcfg.admission
        self.server.uses_pins = True     # prefetch pins need expiry sweeps
        self.server.finish_listeners.append(self._on_finish)
        self.server.failure_listeners.append(self._on_failure)
        try:
            res = self.server.serve(self, max_steps=max_steps)
        finally:
            self.server.finish_listeners.remove(self._on_finish)
            self.server.failure_listeners.remove(self._on_failure)
            self.server.sched.cfg.admission = prev_admission
            self.server.uses_pins = prev_pins
        res.update(self.telemetry.summary())
        res["closed_loop"] = True
        res["frontend_heap_ops"] = self.heap_ops
        return res
