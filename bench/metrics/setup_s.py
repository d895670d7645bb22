"""Process start to the window's start: imports, CUDA, kernels built or
loaded, weights, the pool, and the warm-up traffic (host clock)."""
import math


def read(run):
    return None if math.isnan(run.setup_s) else run.setup_s
