"""Control plane, milliseconds a step: the program's ``admit`` span (the
admission scan inside ``ChunkingScheduler.schedule``), summed over the
window's steps, over their number."""
import numpy as np

from bench.harness import spans


def read(run):
    w = spans.window(run)
    return None if w is None else 1e3 * float(np.mean(w["admit"]))
