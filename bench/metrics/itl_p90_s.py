"""90th percentile of the gaps between consecutive output tokens of a
request, over every token emitted in the window after its request's
first: the pause a reader of a stream feels, thousands of samples a
window where a tail of per-request TPOT has about a hundred."""
from bench.harness.window import percentile


def read(run):
    g = run.window["gaps"]
    return percentile(g, 90) if g else None
