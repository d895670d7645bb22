"""The measured window and its accounting.

The window is ``[t0, t1)`` on the server's clock (``AsymCacheServer.now``:
the wall time of its steps, dispatch to dispatch, with idle stretches
jumped to the next arrival).  The traffic starts at 0; ``t0`` is the end
of the warm-up.  Requests arriving at or after ``t1`` are never handed
to the server.  After ``t1`` the run goes on until every request that
arrived in the window has its first token, or ``drain_s`` has passed;
then every request still queued or running is cancelled, the server
drains its pipeline and ``serve`` returns.

What is counted, and how:

* ``attempted``: requests that arrived in the window (open loop).  For a
  batch that is all due at the start (``at_start``), the requests the
  server admitted in the window: the rest is queued work of the batch.
* ``failed``: attempted requests that were rejected or failed, or that
  had no first token when the run ended.  In a batch, one admitted but
  not yet prefilled at the window's end is queued work of the batch, not
  a failure, and the run stops at the window's end: a batch has no
  latency limit.
* TTFT: ``first_token_at - arrival`` of every attempted request, on the
  server's clock; one with no first token is counted at the run's end,
  ``end - arrival``, a lower bound that ranks it among the slowest.
* inter-token gaps: for every token emitted in the window after its
  request's first, the time since that request's previous token, token
  times as the server emits them.
* output tokens: every token emitted in the window, over the window's
  seconds.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (numpy's default) of all values."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Window:
    def __init__(self, server, t0: float, seconds: float, drain_s: float,
                 at_start: bool = False, tracer=None):
        self.server = server
        self.t0 = float(t0)
        self.t1 = float(t0) + float(seconds)
        self.t_stop = self.t1 + float(drain_s)
        self.seconds = float(seconds)
        self.at_start = at_start
        self.tracer = tracer
        self.requests: List = []          # every request handed over
        self.tokens: Dict[int, List[float]] = {}   # rid -> [n, first, last]
        self.tokens_in_window = 0
        self.gaps: List[float] = []       # inter-token gaps in the window
        self.wall_t0: Optional[float] = None
        self.wall_t1: Optional[float] = None
        self.snap0: Optional[Dict] = None
        self.snap1: Optional[Dict] = None
        self.stopped = False
        self.end_now = math.nan

    # -- hooks ------------------------------------------------------------
    def on_token(self, req, token_id) -> None:
        now = self.server.now
        rec = self.tokens.get(req.rid)
        inside = self.t0 <= now < self.t1
        if rec is None:
            self.tokens[req.rid] = [1, now, now]
        else:
            if inside:
                self.gaps.append(now - rec[2])
            rec[0] += 1
            rec[2] = now
        if inside:
            self.tokens_in_window += 1

    def handed(self, reqs) -> None:
        self.requests.extend(reqs)

    def cutoff(self) -> float:
        """Arrivals strictly before ``t1`` are handed to the server."""
        return math.nextafter(self.t1, -math.inf)

    def _snapshot(self) -> Dict:
        s = self.server
        eng = s.engine
        return {"wall": time.perf_counter(), "now": s.now,
                "control_plane_time": s.control_plane_time,
                "steps": eng.steps_executed,
                "hits": s.bm.n_hits, "lookups": s.bm.n_lookups,
                "evictions": s.bm.n_evictions,
                "waiting": len(s.sched.waiting),
                "running": len(s.sched.running)}

    def tick(self, now: float) -> None:
        """Called at the top of every loop of ``serve`` (inside the
        source's ``pop_due``), between two dispatches."""
        if self.snap0 is None and now >= self.t0:
            self.snap0 = self._snapshot()
            self.wall_t0 = self.snap0["wall"]
        if self.tracer is not None and self.snap0 is not None:
            self.tracer.tick(now, self)
        if self.snap1 is None and now >= self.t1:
            self.snap1 = self._snapshot()
            self.wall_t1 = self.snap1["wall"]
        if self.snap1 is not None and not self.stopped:
            if now >= self.t_stop or not self._pending_first_token():
                self._stop(now)

    def _pending_first_token(self) -> bool:
        """An open-loop request of the window still waits for its first
        token (a batch has no latency to wait for)."""
        return not self.at_start and any(
            not r.terminal and r.rid not in self.tokens
            for r in self.attempted())

    def _stop(self, now: float) -> None:
        sched = self.server.sched
        for req in list(sched.waiting) + list(sched.running):
            self.server.cancel(req)
        self.stopped = True
        self.end_now = now

    # -- results ----------------------------------------------------------
    def attempted(self) -> List:
        if self.at_start:
            return [r for r in self.requests
                    if self.t0 <= r.admitted_at < self.t1]
        return [r for r in self.requests if self.t0 <= r.arrival < self.t1]

    def summary(self) -> Dict:
        """The window's requests, tokens and their latencies (host clock
        of the server), and the counters' changes across it."""
        end = self.end_now if not math.isnan(self.end_now) \
            else self.server.now
        att = self.attempted()
        failed = 0
        ttfts = []
        for r in att:
            got = r.rid in self.tokens
            if r.status in ("rejected", "failed") or not (
                    got or self.at_start):
                failed += 1
            if got and not math.isnan(r.first_token_at):
                ttfts.append(r.first_token_at - r.arrival)
            else:
                ttfts.append(end - r.arrival)
        s0, s1 = self.snap0, self.snap1
        d = {k: s1[k] - s0[k] for k in s0} if s0 and s1 else {}
        return {"attempted": len(att), "failed": failed, "ttfts": ttfts,
                "gaps": self.gaps,
                "tokens": self.tokens_in_window,
                "seconds": self.seconds, "delta": d,
                "wall_s": (self.wall_t1 - self.wall_t0)
                if self.wall_t1 is not None and self.wall_t0 is not None
                else math.nan,
                "drain_s": end - self.t1,
                "at_t0": s0, "at_t1": s1}
