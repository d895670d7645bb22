"""Model step, percent: the share of the window's whole steps that ran
from a captured CUDA graph (the program's ``replay`` span, inside
``enqueue``, took time in them).  None from a program without graphs
(its engine's ``perf_counters()`` has no ``graph_replays``), or where
no window step was recorded; 0 where the program has graphs and no
window step replayed one."""
import numpy as np

from bench.harness import spans


def read(run):
    w = spans.served_by(run)
    engine = getattr(getattr(w, "server", None), "engine", None)
    counters = getattr(engine, "perf_counters", None)
    if not callable(counters) or "graph_replays" not in counters():
        return None
    steps = spans.window(run)
    if steps is None:
        return None
    if "replay" not in steps:
        return 0.0
    return 100.0 * float(np.mean(steps["replay"] > 0))
