"""The serving loop's tracer (``repro_torch.serving.tracing``) on the CPU
with the smoke model: one span tree a dispatched step, ``schedule`` and
``assemble`` on the clock reads of ``control_plane_time``, the admission
counters, nothing recorded and no clock read or profiler range added
with tracing off, and the in-memory spans on a profiler's clock through
the anchors."""
import json
import os
import tempfile
import textwrap
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.analysis import step_hazards
from repro_torch.configs import get_smoke_config, scaled_config
from repro_torch.models import init_params
from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                 SchedulerConfig, ScriptedSource,
                                 ServerConfig, WorkloadConfig,
                                 multi_turn_workload)
from repro_torch.serving.tracing import ANCHOR, PREFIX, Tracer, clock_map

# the direct children a step tree may have, and how many of each
CHILDREN = {"poll", "schedule", "assemble", "enqueue", "postprocess",
            "retire", "wait"}


@pytest.fixture(autouse=True)
def _no_profiler_left_recording():
    """Each test starts with no profiler recording: one that an earlier
    test left recording would have every server here follow it."""
    if torch.autograd._profiler_enabled():
        torch.autograd._disable_profiler()
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(_one_thread):
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _server(model, num_blocks=64, depth=1, clock="wall"):
    cfg, params = model
    scfg = ServerConfig(num_blocks=num_blocks, block_size=16, clock=clock,
                        pipeline_depth=depth,
                        scheduler=SchedulerConfig(token_budget=128,
                                                  max_chunk=64,
                                                  max_prefills=2,
                                                  max_decodes=8))
    ecfg = EngineConfig(num_pages=num_blocks, page_size=16, max_prefills=2,
                        max_chunk=64, max_decodes=8)
    return AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device="cpu")


def _workload(n_sessions=4, qps=50.0):
    return multi_turn_workload(WorkloadConfig(
        n_sessions=n_sessions, turns_per_session=(2, 3),
        first_ctx_len=(96, 180), output_len=(12, 30), qps=qps, seed=3))


def _names(ex):
    return np.asarray(ex["names"])[ex["name"]]


def _traced_run(model, depth=1, qps=50.0, **kw):
    srv = _server(model, depth=depth, **kw)
    srv.enable_tracing()
    nows = []
    dispatch = srv.engine.dispatch

    def recorded(plan):
        nows.append(srv.now)
        return dispatch(plan)
    srv.engine.dispatch = recorded
    out = srv.run(_workload(qps=qps))
    return srv, out, srv.trace_export(), nows


@pytest.mark.parametrize("depth", [0, 1])
def test_every_dispatched_step_has_one_tree(model, depth):
    srv, out, ex, nows = _traced_run(model, depth=depth, qps=2.0)
    names, st = _names(ex), ex["steps"]
    assert ex["spans_dropped"] == 0 and not np.isnan(ex["t1"]).any()
    assert len(st["span"]) == out["steps"] == len(nows)
    roots = np.flatnonzero(names == "step")
    assert np.array_equal(roots, st["span"])
    assert np.array_equal(ex["step"][roots], np.arange(out["steps"]))
    # the step's attributes: the server's now at dispatch, the plan's shape
    assert np.array_equal(st["now"], nows)
    assert (st["t_bucket"] > 0).all() and (st["k"] == 1).all()
    assert (st["prefill_rows"] + st["decode_rows"] > 0).all()
    # the tree: the root's span holds every span of its step, each child
    # lies inside its parent
    for s, root in enumerate(roots):
        mine = np.flatnonzero(ex["step"] == s)
        assert ex["parent"][root] == -1
        assert (ex["t0"][mine] >= ex["t0"][root]).all()
        assert (ex["t1"][mine] <= ex["t1"][root]).all()
        kids = Counter(names[mine[ex["parent"][mine] == root]])
        assert set(kids) <= CHILDREN
        assert kids["assemble"] == kids["enqueue"] == 1
        assert kids["postprocess"] == 1
        assert kids["poll"] == kids["schedule"] >= 1
        # the pipeline retires the step before from the second step on;
        # the synchronous loop waits for its own step, then retires it
        assert kids["retire"] == (0 if depth == 1 and s == 0 else 1)
        assert kids["wait"] == (1 if depth == 0 else 0)
    kids = ex["parent"] >= 0
    par = ex["parent"][kids]
    assert (ex["t0"][kids] >= ex["t0"][par]).all()
    assert (ex["t1"][kids] <= ex["t1"][par]).all()
    # admit lies in schedule, wait in retire (or the step at depth 0)
    assert set(names[par[names[kids] == "admit"]]) == {"schedule"}
    assert set(names[par[names[kids] == "wait"]]) == \
        ({"step", "retire"} if depth == 0 else {"retire"})
    # the pipeline's drain retires outside any step
    if depth == 1:
        assert set(names[ex["step"] == -1]) == {"retire", "wait"}


def test_schedule_and_assemble_are_the_control_plane_time(model):
    srv, out, ex, _ = _traced_run(model)
    names = _names(ex)
    d = ex["t1"] - ex["t0"]
    got = d[(names == "schedule") | (names == "assemble")].sum()
    assert got == pytest.approx(out["control_plane_time"], rel=1e-3)
    assert got > 0


def test_admission_counters(model):
    srv, out, ex, _ = _traced_run(model, num_blocks=24)
    sched, st = srv.sched, ex["steps"]
    assert 0 < sched.admitted <= sched.admit_tries
    # a pool too small to admit everyone at once: requests wait and are
    # tried again
    assert sched.admitted < sched.admit_tries
    assert sched.admitted == out["n_requests"]
    assert st["admit_tries"].sum() == sched.admit_tries
    assert st["admitted"].sum() == sched.admitted
    # the counters stay out of the frozen result schemas
    for key in ("admit_tries", "admitted"):
        assert key not in out
        assert key not in srv.engine.perf_counters()
        assert key not in srv.bm.counters()


class _Counting:
    """Counts the constructions of ``record_function`` (each one is
    entered) and the calls of a clock."""

    def __init__(self, inner):
        self.inner = inner
        self.n = 0

    def __call__(self, *a, **k):
        self.n += 1
        return self.inner(*a, **k)


def _count(monkeypatch):
    rf = _Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", rf)
    pc = _Counting(time.perf_counter)
    monkeypatch.setattr(time, "perf_counter", pc)
    ns = _Counting(time.perf_counter_ns)
    monkeypatch.setattr(time, "perf_counter_ns", ns)
    return rf, pc, ns


@pytest.mark.parametrize("traced", [False, True])
def test_tracing_off_adds_no_clock_read_and_no_range(model, monkeypatch,
                                                     traced):
    srv = _server(model)
    if traced:
        srv.enable_tracing()
    schedule = srv.sched.schedule
    loops = []

    def counted(now):
        loops.append(now)
        return schedule(now)
    srv.sched.schedule = counted
    rf, pc, ns = _count(monkeypatch)
    out = srv.run(_workload())
    # no profiler records: no range, traced or not
    assert rf.n == 0
    assert ns.n == 0
    if not traced:
        assert srv.trace_export() is None and srv.tracer is None
        # the loop's own reads: the run's start and end, two around each
        # schedule, and at each dispatch its own, the assembly's two and
        # the wall clock's two
        assert pc.n == 2 + 2 * len(loops) + 5 * out["steps"]
    else:
        ex = srv.trace_export()
        assert len(ex["steps"]["span"]) == out["steps"]
        assert not ex["steps"]["cut"].any()
        assert pc.n > 2 + 2 * len(loops) + 5 * out["steps"]


def test_enabled_tracer_enters_ranges_under_a_profiler(model, monkeypatch):
    srv = _server(model)
    srv.enable_tracing()
    rf, _, _ = _count(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = srv.run(_workload(n_sessions=2))
    ex = srv.trace_export()
    assert len(ex["steps"]["span"]) == out["steps"]
    # every span and each layer's attention and MLP under the profiler
    n_layers = srv.cfg.n_layers
    assert rf.n >= len(ex["name"]) + 2 * n_layers * out["steps"]


class _ProfiledSource(ScriptedSource):
    """Starts a CPU profiler at the ``begin``-th poll and stops it at the
    ``end``-th, from inside the loop as the benchmark's stretch does."""

    def __init__(self, requests, begin, end):
        super().__init__(requests)
        self.begin, self.end = begin, end
        self.polls = 0
        self.prof = None
        self.bounds = []

    def pop_due(self, now):
        self.polls += 1
        if self.polls == self.begin:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            self.prof.start()
            self.bounds.append(time.perf_counter())
        elif self.polls == self.end:
            self.bounds.append(time.perf_counter())
            self.prof.stop()
        return super().pop_due(now)


def _trace_events(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"]
    finally:
        os.remove(path)


def test_spans_meet_their_profiler_twins(model):
    srv = _server(model)
    srv.enable_tracing()
    src = _ProfiledSource(_workload(), begin=10, end=50)
    srv.serve(src)
    ex = srv.trace_export()
    evs = _trace_events(src.prof)
    anchors = [e["ts"] for e in evs if e["name"] == ANCHOR]
    assert len(anchors) == len(ex["anchors"]) > 10
    slope, offset = clock_map(ex["anchors"], anchors)
    assert abs(slope - 1.0) < 1e-3
    lo, hi = src.bounds
    inside = (ex["t0"] > lo) & (ex["t1"] < hi)
    names = _names(ex)
    mapped = lambda t: slope * 1e6 * t + offset          # noqa: E731
    late = []
    for name in set(names[inside]):
        twins = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                       if e["name"] == PREFIX + name)
        start = np.array([a for a, _ in twins])
        end = np.array([b for _, b in twins])
        sel = inside & (names == name)
        t0, t1 = mapped(ex["t0"][sel]), mapped(ex["t1"][sel])
        # each span's twin: the range of its name that starts nearest
        at = np.clip(np.searchsorted(start, t0), 1, len(start) - 1)
        j = np.where(np.abs(start[at] - t0) < np.abs(start[at - 1] - t0),
                     at, at - 1)
        d0, d1 = np.abs(start[j] - t0), np.abs(end[j] - t1)
        # a span's reads follow its range's own; where the thread stalled
        # between the two at one end, the other end still meets
        assert (np.minimum(d0, d1) < 50.0).all(), (name, d0.max(), d1.max())
        late += list(d0)
    assert len(late) > 100
    assert np.mean(np.array(late) < 50.0) > 0.98
    # the engine's layer ranges: one attention and one MLP a layer a step
    steps = int(((ex["t0"] > lo) & (ex["t1"] < hi)
                 & (names == "enqueue")).sum())
    n_attn = sum(e["name"] == PREFIX + "attn" for e in evs)
    assert n_attn >= srv.cfg.n_layers * steps > 0
    assert sum(e["name"] == PREFIX + "mlp" for e in evs) == n_attn


def test_a_tracer_follows_the_profiler(model, monkeypatch):
    """Without ``enable_tracing`` the server records exactly while a
    profiler records: the steps that begin inside the profile, the one it
    stops in flagged ``cut``; nothing before or after, and no range."""
    srv = _server(model)
    src = _ProfiledSource(_workload(), begin=10, end=40)
    schedule = srv.sched.schedule
    polls = []

    def counted(now):
        polls.append(src.polls)
        return schedule(now)
    srv.sched.schedule = counted
    dispatch = srv.engine.dispatch
    nows = []

    def recorded(plan):
        nows.append((src.polls, srv.now))
        return dispatch(plan)
    srv.engine.dispatch = recorded
    srv.serve(src)
    assert srv.tracer is None and srv.engine.layer_ranges is False
    ex = srv.trace_export()
    st = ex["steps"]
    lo, hi = src.bounds
    # the steps dispatched from the poll after the start to the stop's
    want = [now for poll, now in nows if 10 < poll <= 40]
    assert np.array_equal(st["now"], want) and len(want) > 10
    assert st["cut"].tolist() == [0] * (len(want) - 1) + [1]
    names = _names(ex)
    roots = ex["step"] >= 0
    assert (ex["t0"][roots] > lo).all()
    assert ex["t0"][st["span"][-1]] < hi < ex["t1"][st["span"][-1]]
    # ranges while the profiler records: the anchors, one a step
    evs = _trace_events(src.prof)
    assert sum(e["name"] == ANCHOR for e in evs) == len(ex["anchors"])
    assert sum(e["name"] == PREFIX + "step" for e in evs) == len(want)
    assert set(names) >= {"step", "poll", "schedule", "assemble",
                          "enqueue", "postprocess", "retire"}
    # admission counts of the recorded steps only
    assert st["admit_tries"].sum() <= srv.sched.admit_tries
    # and a later run with no profiler records nothing more
    rf, pc, ns = _count(monkeypatch)
    srv.run(_workload(n_sessions=2))
    assert rf.n == 0
    assert len(srv.trace_export()["steps"]["span"]) == len(want)


def test_capacity_drops_and_counts(model):
    srv = _server(model)
    srv.tracer = None
    tr = srv.enable_tracing(capacity=40)
    out = srv.run(_workload())
    ex = srv.trace_export()
    assert len(ex["name"]) == 40
    assert ex["spans_dropped"] > 0
    assert len(ex["steps"]["span"]) == min(out["steps"], 40)
    assert not tr._stack


def test_discard_drops_a_tree_that_dispatched_nothing():
    tr = Tracer(capacity=16)
    tr.open_step()
    tr.open("poll")
    tr.close()
    tr.discard()
    assert tr.n == 0 and not tr._stack
    tr.open_step()
    tr.dispatched(0.5, _Plan(), admit_tries=3, admitted=1)
    tr.open("retire")
    tr.discard()                   # left open by a raise: kept, closed
    ex = tr.export()
    assert list(_names(ex)) == ["step", "retire"]
    assert not np.isnan(ex["t1"]).any()
    assert ex["steps"]["admit_tries"].tolist() == [3]


class _Plan:
    t_bucket = None
    prefills = []
    decodes = [object()]
    decode_steps = 1


def test_clock_map_ignores_late_ranges():
    t = np.linspace(100.0, 103.0, 300)
    ts = 1e6 * t * (1 + 2e-6) + 5e11
    late = ts.copy()
    late[::17] += 800.0            # a range entered late
    slope, offset = clock_map(t, late)
    assert np.abs(slope * 1e6 * t + offset - ts).max() < 1.0
    assert clock_map([], []) is None


def test_step_hazard_pass_keeps_a_profiler_range_and_flags_a_clock():
    ranged = """\
        import torch

        class E:
            def step(self, x, l: int):
                with torch.profiler.record_function("repro.attn"):
                    y = x * 2
                with self._range("moe"):
                    y = y + 1
                return y

            def _range(self, name: str):
                if self.layer_ranges:
                    return torch.profiler.record_function("repro." + name)
                return None
    """
    assert step_hazards.scan_source(textwrap.dedent(ranged)) == []
    planted = ranged.replace(
        'y = x * 2', 'y = x * 2\n                t = time.perf_counter()')
    fs = step_hazards.scan_source(textwrap.dedent(planted))
    assert [(f.code, f.line) for f in fs] == [("nondeterminism", 7)]
