"""Request sources that drive the port's serving entry points through the
window: the online frontend for agent traffic (``OnlineFrontend.run``,
its session layer and closed loop as the program has them), and a
closed-loop session source of the benchmark's own for chat and batch
traffic (the ``ScriptedSource`` protocol: ``pop_due`` / ``next_time`` /
``done``).  Both hand the server only arrivals before the window's end,
and let the window stop the run (``Window.tick``)."""
from __future__ import annotations

import heapq
from typing import List

from repro_torch.serving import (FrontendConfig, OnlineFrontend, Request,
                                 SessionScript, TurnScript)

from bench.harness.traffic import Session


def session_scripts(sessions: List[Session]) -> List[SessionScript]:
    """The frontend's scripts of the generated sessions: every turn but
    the last ends in a tool call whose announced duration is its actual
    one (Continuum's predictable tools)."""
    out = []
    for s in sessions:
        turns = [TurnScript(output=t.output.tolist(),
                            tool_result=t.next_input.tolist(),
                            is_tool=i < len(s.turns) - 1,
                            tool_duration=t.gap_s, actual_duration=t.gap_s)
                 for i, t in enumerate(s.turns)]
        out.append(SessionScript(sid=s.sid, arrival=s.arrival,
                                 history0=s.history0.tolist(), turns=turns))
    return out


class WindowedFrontend(OnlineFrontend):
    """``OnlineFrontend`` with predictive prefetch off and its default
    admission, whose arrivals stop at the window's end."""

    def __init__(self, server, sessions: List[Session], window):
        super().__init__(server, session_scripts(sessions),
                         FrontendConfig(prefetch=False),
                         on_token=window.on_token)
        self.window = window

    def pop_due(self, now: float):
        self.window.tick(now)
        due = super().pop_due(min(now, self.window.cutoff()))
        self.window.handed(due)
        return due

    def next_time(self):
        nt = super().next_time()
        return nt if nt is not None and nt < self.window.t1 else None

    def done(self) -> bool:
        return self.window.stopped or super().done()


class SessionSource:
    """Closed-loop sessions: a session's first turn arrives at its start
    time, each later turn ``gap_s`` after the previous turn's last token
    (the server's finish listener), its prompt the whole history: the
    previous prompt, its output and the next input."""

    def __init__(self, server, sessions: List[Session], window):
        self.server = server
        self.window = window
        self._heap = []
        self._seq = 0
        self._rid = 0
        self._state = {}      # sid -> [session, next turn index, history]
        for s in sessions:
            self._state[s.sid] = [s, 0, s.history0.tolist()]
            self._push(s.arrival, s.sid)
        server.finish_listeners.append(self._on_finish)

    def _push(self, when: float, sid: int) -> None:
        heapq.heappush(self._heap, (when, self._seq, sid))
        self._seq += 1

    def _request(self, sid: int, when: float) -> Request:
        sess, i, hist = self._state[sid]
        turn = sess.turns[i]
        req = Request(rid=self._rid, session_id=sid, prompt_tokens=hist,
                      output_script=turn.output.tolist(), arrival=when,
                      turn_index=i, resumed=i > 0,
                      on_token=self.window.on_token)
        self._rid += 1
        return req

    def _on_finish(self, req: Request, now: float) -> None:
        st = self._state.get(req.session_id)
        if st is None:
            return
        sess, i, hist = st
        turn = sess.turns[i]
        st[1] = i + 1
        if st[1] < len(sess.turns):
            st[2] = hist + turn.output.tolist() + turn.next_input.tolist()
            self._push(now + turn.gap_s, req.session_id)

    def pop_due(self, now: float):
        self.window.tick(now)
        cut = min(now, self.window.cutoff())
        out = []
        while self._heap and self._heap[0][0] <= cut:
            when, _, sid = heapq.heappop(self._heap)
            out.append(self._request(sid, when))
        self.window.handed(out)
        return out

    def next_time(self):
        if self._heap and self._heap[0][0] < self.window.t1:
            return self._heap[0][0]
        return None

    def done(self) -> bool:
        return self.window.stopped or not any(
            when < self.window.t1 for when, _, _ in self._heap[:1])

    def close(self) -> None:
        self.server.finish_listeners.remove(self._on_finish)
