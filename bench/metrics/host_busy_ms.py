"""Server loop (host), milliseconds a step: the mean over the window's
whole steps of the program's ``step`` span (one dispatching iteration of
``serve``) less the time it waits for the device (``wait``)."""
import numpy as np

from bench.harness import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    return 1e3 * float(np.mean(w["dur"] - w["wait"]))
