"""The window's accounting on a hand-made server: what counts as
attempted and failed, the TTFT of a request with no first token, the inter-token gaps,
tokens, and percentiles over all requests."""
import math
from types import SimpleNamespace

from bench.harness.window import Window, percentile


class _Req(SimpleNamespace):
    @property
    def terminal(self):
        return self.status in ("finished", "failed", "rejected",
                               "cancelled")


def _server():
    bm = SimpleNamespace(n_hits=0, n_lookups=0, n_evictions=0)
    sched = SimpleNamespace(waiting=[], running=[])
    eng = SimpleNamespace(steps_executed=0)
    srv = SimpleNamespace(now=0.0, control_plane_time=0.0, bm=bm,
                          sched=sched, engine=eng)
    srv.cancel = lambda r: setattr(r, "status", "cancelled")
    return srv


def _req(rid, arrival, status="finished", first=math.nan):
    return _Req(rid=rid, arrival=arrival, status=status,
                first_token_at=first, admitted_at=arrival)


def test_accounting():
    srv = _server()
    w = Window(srv, t0=10.0, seconds=10.0, drain_s=5.0)
    early = _req(0, 5.0, first=6.0)          # before the window
    ok = _req(1, 11.0, first=11.5)
    slow = _req(2, 12.0, first=14.0)
    never = _req(3, 19.0, status="running")  # no first token at the end
    rejected = _req(4, 13.0, status="rejected")
    w.handed([early, ok, slow, never, rejected])
    for now, r in [(6.0, early), (11.5, ok), (12.5, ok), (13.5, ok),
                   (14.0, slow), (20.5, slow)]:
        srv.now = now
        w.on_token(r, 7)
    srv.sched.running = [never]
    w.tick(10.0)
    srv.bm.n_hits, srv.bm.n_lookups = 3, 4
    srv.engine.steps_executed = 8
    srv.control_plane_time = 0.4
    w.tick(20.0)
    assert not w.stopped            # ``never`` still waits for a token
    w.tick(25.0)                    # the drain ends: everything cancelled
    assert w.stopped and never.status == "cancelled"
    s = w.summary()
    assert s["attempted"] == 4      # ok, slow, never, rejected
    assert s["failed"] == 2         # never (no token), rejected
    # the one with no first token counts at the run's end
    assert sorted(s["ttfts"]) == [0.5, 2.0, 6.0, 12.0]
    # gaps of the tokens emitted in the window after their request's
    # first: ``ok``'s second and third; ``slow``'s second came after it
    assert s["gaps"] == [1.0, 1.0]
    assert s["tokens"] == 4         # 11.5, 12.5, 13.5, 14.0
    assert s["delta"]["hits"] == 3 and s["delta"]["steps"] == 8


def test_arrivals_stop_at_the_window_end():
    w = Window(_server(), t0=0.0, seconds=2.0, drain_s=1.0)
    assert w.cutoff() < 2.0 and w.cutoff() > 2.0 - 1e-9


def test_batch_counts_what_the_window_admitted():
    w = Window(_server(), t0=10.0, seconds=10.0, drain_s=5.0,
               at_start=True)
    a, b = _req(0, 0.0), _req(1, 0.0)
    a.admitted_at, b.admitted_at = 5.0, 12.0
    c = _req(2, 0.0)
    c.admitted_at = math.nan                 # still queued
    w.handed([a, b, c])
    assert w.attempted() == [b]


def test_percentile_is_over_all_values():
    vals = list(range(1, 101))
    assert percentile(vals, 50) == 50.5
    assert percentile(vals, 95) == 95.05
    assert percentile([3.0], 95) == 3.0
