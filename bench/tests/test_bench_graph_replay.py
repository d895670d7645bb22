"""The ``graph_replay_share`` reader on hand-made exports: the share of
the window's whole steps with a ``replay`` span; 0 from a program with
graphs whose window steps replayed none; None from a program whose
engine counts no graphs (the benchmark's parent), and where nothing was
recorded."""
from types import SimpleNamespace

import pytest

from bench.harness import spans
from bench.tests.test_bench_spans import _export, _reader, _run, _tree

MS = 1e-3


def _replayed(t, replay_ms):
    """A step at ``t`` whose enqueue (40-70 ms) holds a replay span of
    ``replay_ms`` (none where 0)."""
    tree = _tree(t)
    if replay_ms:
        tree.append(("replay", t + 41 * MS, t + (41 + replay_ms) * MS, 5))
    return tree


def _with_engine(run, counters):
    spans.served_by(run).server.engine = SimpleNamespace(
        perf_counters=lambda: counters)
    return run


GRAPHS = {"engine_dispatches": 4, "graph_captures": 1, "graph_replays": 2,
          "graph_eager_steps": 1}


def test_share_of_window_steps_that_replayed():
    # steps at 0.5 (before the window), 1.0 and 1.2 (replayed), 1.3
    # (cut), 1.4 (eager) and 1.6 (replayed); the window is [1, 2)
    trees = [_replayed(0.5, 2), _replayed(1.0, 3), _replayed(1.2, 1),
             _replayed(1.3, 2), _replayed(1.4, 0), _replayed(1.6, 2)]
    run = _with_engine(_run(_export(trees, cut=[3])), GRAPHS)
    assert _reader("graph_replay_share")(run) == pytest.approx(75.0)


def test_no_replay_span_in_the_window_reads_zero():
    trees = [_replayed(0.5, 2), _replayed(1.0, 0), _replayed(1.5, 0)]
    run = _with_engine(_run(_export(trees)), GRAPHS)
    assert _reader("graph_replay_share")(run) == 0.0


def test_a_program_without_graphs_reads_nothing():
    trees = [_replayed(1.0, 2), _replayed(1.5, 2)]
    read = _reader("graph_replay_share")
    parent = {k: v for k, v in GRAPHS.items() if not k.startswith("graph")}
    assert read(_with_engine(_run(_export(trees)), parent)) is None
    # no engine to ask, no window to reach, no step recorded
    assert read(_run(_export(trees))) is None
    assert read(_run(_export(trees), requests=[])) is None
    assert read(_with_engine(_run(None), GRAPHS)) is None
