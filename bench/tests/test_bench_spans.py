"""The readers of the program's spans on hand-made runs: the window's
steps by ``now``, each metric's arithmetic, None where there is nothing
to read (a program without the tracer, no window, no trace), the idle
gaps put down to the in-memory spans mapped by the stretch's own clock
reads; and traced runs of the harness at smoke size, with the tracer and
without it."""
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench.harness import cell, spans, trace
from bench.harness.cell import Run
from bench.harness.peaks import H100
from bench.harness.spec import Spec
from bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NEW = ("host_busy_ms", "admission_ms", "admit_yield", "enqueue_ms",
       "idle_control_plane_ms")
OLD = ("control_plane_ms", "block_hit_rate", "step_mfu", "attn_roofline",
       "device_idle_share")
MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256, "family": "dense"}
SEED = 2**31 + 4242


def _reader(name):
    return Spec(ROOT).reader(name)


def _export(trees, cut=()):
    """An export of ``trees``: one list a step of (name, start, end,
    parent index in the list or None); each step's ``now`` is its
    root's start, its counts (3, 1); the steps in ``cut`` flagged."""
    names, rows = [], []
    st = {k: [] for k in ("span", "now", "t_bucket", "prefill_rows",
                          "decode_rows", "k", "admit_tries", "admitted",
                          "cut")}
    for s, tree in enumerate(trees):
        base = len(rows)
        for name, a, b, par in tree:
            if name not in names:
                names.append(name)
            rows.append((names.index(name), a, b,
                         -1 if par is None else base + par, s))
        for k, v in (("span", base), ("now", tree[0][1]), ("t_bucket", 64),
                     ("prefill_rows", 0), ("decode_rows", 4), ("k", 1),
                     ("admit_tries", 3), ("admitted", 1),
                     ("cut", int(s in cut))):
            st[k].append(v)
    cols = list(zip(*rows))
    return {"names": names, "name": np.array(cols[0], np.int16),
            "t0": np.array(cols[1]), "t1": np.array(cols[2]),
            "parent": np.array(cols[3], np.int32),
            "step": np.array(cols[4], np.int32),
            "steps": {k: np.array(v) for k, v in st.items()},
            "anchors": np.zeros(0), "spans_dropped": 0}


def _tree(t, wait=0.0, admit=0.0):
    """A 100 ms step at ``t``: poll 10, schedule 20 (admit inside),
    assemble 10, enqueue 30, postprocess 10, retire 15 (wait inside)."""
    ms = 1e-3
    return [("step", t, t + 100 * ms, None),
            ("poll", t, t + 10 * ms, 0),
            ("schedule", t + 10 * ms, t + 30 * ms, 0),
            ("admit", t + 11 * ms, t + (11 + admit) * ms, 2),
            ("assemble", t + 30 * ms, t + 40 * ms, 0),
            ("enqueue", t + 40 * ms, t + 70 * ms, 0),
            ("postprocess", t + 70 * ms, t + 80 * ms, 0),
            ("retire", t + 80 * ms, t + 95 * ms, 0),
            ("wait", t + 81 * ms, t + (81 + wait) * ms, 7)]


class _Window:
    """What the readers reach through a request: the server (with or
    without ``trace_export``) and the harness's stretch tracer."""

    def __init__(self, ex=None, events=None, wall=None, program=True):
        self.server = SimpleNamespace()
        if program:
            self.server.trace_export = lambda: ex
        self.tracer = SimpleNamespace(events=events, wall=wall)

    def on_token(self, req, token_id):
        pass


def _run(ex=None, trace_=None, t0=1.0, t1=2.0, events=None, wall=None,
         program=True, requests=None):
    w = _Window(ex, events, wall, program)
    reqs = [SimpleNamespace(on_token=None),
            SimpleNamespace(on_token=w.on_token)] \
        if requests is None else requests
    return Run(workload="t", model=MODEL, deployment={"block_size": 16},
               peaks=H100, window={"delta": {}, "wall_s": 1.0}, steps=[],
               t0=t0, t1=t1, setup_s=1.0, requests=reqs, trace=trace_)


def test_readers_read_nothing_without_the_program_tracer():
    ex = _export([_tree(1.0)])
    stretch = {"kernels": [("k", 0.0, 1.0)], "steps": [object()],
               "window_s": 1.0, "busy_s": 0.5}
    events = {"kernels": [("k", 0.0, 1.0)], "spans": [],
              "mark": (0.0, 2.0)}
    runs = [_run(ex, requests=[]),                    # no window to reach
            _run(ex, program=False),                  # the program before
            _run(None),                               # nothing recorded
            _run(ex, t0=5.0, t1=6.0),                 # no window step
            _run(_export([_tree(1.0)], cut=[0]))]     # its only step cut
    for run in runs:
        for name in NEW:
            assert _reader(name)(run) is None, name
    # the device trace without its stretch's clock reads, or none at all
    assert _reader("idle_control_plane_ms")(
        _run(ex, stretch, events=events)) is None
    assert _reader("idle_control_plane_ms")(
        _run(ex, None, events=events, wall=[0.0, 2.0])) is None


def test_span_readers_over_the_window_steps():
    # steps at 0.5 (before the window), 1.0, 1.3 (cut) and 1.5 (in it),
    # 2.0 (after)
    trees = [_tree(0.5, wait=50), _tree(1.0, wait=10, admit=4),
             _tree(1.3, wait=90, admit=90), _tree(1.5, wait=20, admit=8),
             _tree(2.0, wait=50)]
    run = _run(_export(trees, cut=[2]))
    w = spans.window(run)
    assert np.allclose(w["now"], [1.0, 1.5])
    assert np.allclose(w["self"], 0.005)            # 100 - 95 ms
    got = {n: _reader(n)(run) for n in NEW}
    # (100 - 10) and (100 - 20): mean 85 ms
    assert got["host_busy_ms"] == pytest.approx(85.0)
    assert got["admission_ms"] == pytest.approx(6.0)
    assert got["enqueue_ms"] == pytest.approx(30.0)
    assert got["admit_yield"] == pytest.approx(100.0 / 3)
    assert got["idle_control_plane_ms"] is None     # no trace
    # a window whose steps tried no admission has no yield
    none = _export(trees)
    none["steps"]["admit_tries"][:] = 0
    assert _reader("admit_yield")(_run(none)) is None


def test_idle_gaps_go_to_the_innermost_mapped_span():
    # the profiler's clock runs 5e11 us ahead of perf_counter's, and a
    # little faster; the stretch's clock reads pin both ends
    off, rate = 5e11, 1 + 3e-6
    us = lambda t: 1e6 * (t - 0.99) * rate + 1e6 * 0.99 + off  # noqa: E731
    trees = [_tree(1.0, wait=5, admit=4), _tree(1.1, wait=5, admit=4)]
    ex = _export(trees)
    # kernels leave the device idle: in poll, in admit (in schedule), in
    # assemble, in wait (in retire), and after every step
    busy = [(0.98, 1.0005), (1.0015, 1.012), (1.014, 1.035),
            (1.039, 1.0815), (1.0825, 1.2002), (1.2100, 1.22)]
    events = {"kernels": [("k", us(a), us(b)) for a, b in busy],
              "spans": [], "mark": (us(0.99), us(1.21))}
    stretch = trace.summarise(events)
    stretch["steps"] = [1, 2]
    run = _run(ex, stretch, t0=0.5, t1=1.5, events=events,
               wall=[0.99, 1.21])
    idle = spans.idle_by_span(run)
    assert set(idle) == {"poll", "admit", "assemble", "wait", "outside"}
    assert idle["poll"] == pytest.approx(0.001, rel=1e-4)
    assert idle["admit"] == pytest.approx(0.002, rel=1e-4)
    assert idle["assemble"] == pytest.approx(0.004, rel=1e-4)
    assert idle["outside"] == pytest.approx(0.0098, rel=1e-4)
    # every gap of the stretch is put down once
    total = stretch["window_s"] - stretch["busy_s"]
    assert sum(idle.values()) == pytest.approx(total, rel=1e-9)
    # poll 1 ms, admit 2, assemble 4 over two steps
    assert _reader("idle_control_plane_ms")(run) == pytest.approx(
        3.5, rel=1e-4)
    rep = spans.report(run)
    assert rep["idle_span_open_share"] == pytest.approx(
        1 - idle["outside"] / total)
    assert rep["window_steps"] == 2 and rep["self_share"] > 0
    assert rep["stretch_steps"] == 2


def test_gaps_and_innermost():
    ks = [("a", 0.0, 5.0), ("b", 3.0, 8.0), ("c", 10.0, 12.0),
          ("d", 15.0, 30.0)]
    assert spans.gaps(ks, 1.0, 20.0) == [(8.0, 10.0), (12.0, 15.0)]
    assert spans.gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    iv = [(0.0, 10.0), (2.0, 3.0), (5.0, 8.0), (6.0, 7.0), (12.0, 13.0)]
    pts = [2.5, 9.0, 6.5, 5.5, 3.0, 11.0, 12.0, -1.0]
    assert spans.innermost(pts, iv) == [1, 0, 3, 2, 0, -1, 4, -1]
    assert spans.innermost([], iv) == []
    assert spans.innermost([1.0], []) == [-1]


def test_benchmark_lists_the_new_metrics():
    # the old and new metrics open ``per_layer`` in this order; later
    # metrics and cells may follow
    spec = Spec(ROOT)
    per = spec.bench["per_layer"]
    cells = {w["name"] for w in spec.bench["workloads"]}
    assert [m["name"] for m in per[:len(OLD + NEW)]] == list(OLD + NEW)
    for m in per:
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").is_file()
    for m in per[len(OLD):len(OLD + NEW)]:
        assert m["moves"] == "itl_p90_s"


def test_every_metric_moves_what_its_cells_report():
    # a per-layer metric names an end-to-end metric that each of its
    # cells reports; every cell reports set-up, another end-to-end metric
    # and a per-layer one
    spec = Spec(ROOT)
    cells = [w["name"] for w in spec.bench["workloads"]]
    for c in cells:
        e2e = {m["name"] for m in spec.metrics(c, False)}
        per = spec.metrics(c, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e, (c, m["name"])
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").is_file()


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(tiny.make(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def one_thread():
    """One thread for the host's numerical libraries, as the benchmark's
    entry sets it: the smoke run then keeps its pace beside other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_profiler_left():
    """At smoke size the run can end inside the traced stretch, its
    profiler still recording: stop it before and after the test, so that
    no server of another test follows it."""
    def stop():
        if torch.autograd._profiler_enabled():
            torch.autograd._disable_profiler()
    stop()
    yield
    stop()


@pytest.mark.parametrize("program", [True, False])
def test_traced_run_reads_the_program_spans(spec, program, monkeypatch,
                                            one_thread, no_profiler_left):
    """The harness's traced run at smoke size on the CPU: the span
    metrics read the program's stretch; a program without the tracer
    (``trace_export`` gone) leaves them out and nothing else changes."""
    if not program:
        from repro_torch.serving import AsymCacheServer
        monkeypatch.delattr(AsymCacheServer, "trace_export")
    out = cell.run(spec, "t.chat", SEED, 6.0, True, "cpu",
                   time.perf_counter())
    # the chat cell reads the shared readers under names of its own
    m = {k.removesuffix(".chat"): v["value"]
         for k, v in out["metrics"].items()}
    assert m["rows_computed"] > 0
    # no card: no device trace, so no metric of it
    assert "idle_control_plane_ms" not in m
    spans_ = {"host_busy_ms", "admission_ms", "admit_yield", "enqueue_ms"}
    if program:
        assert spans_ <= set(m)
        assert m["host_busy_ms"] > m["enqueue_ms"] > 0
        assert m["admission_ms"] >= 0 and 0 < m["admit_yield"] <= 100
    else:
        assert not spans_ & set(m)
