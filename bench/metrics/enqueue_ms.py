"""Model step, milliseconds a step: the program's ``enqueue`` span (the
eager ``Engine._step_impl`` call that queues a step's kernels), mean over
the window's steps."""
import numpy as np

from bench.harness import spans


def read(run):
    w = spans.window(run)
    return None if w is None else 1e3 * float(np.mean(w["enqueue"]))
