"""95th percentile of the gaps between consecutive output tokens of a
request, over every token emitted in the window after its request's
first (as ``itl_p90_s``): the chat cell's token-gap tail.

A gap is one step's time, and a step's time follows its token bucket,
so the gaps fall on a few levels.  In the chat cell about 85% of the
gaps come from decode-only steps, about 5% from steps with a short
chunk and 8-10% from steps with a long one: the 90th percentile lies
where the second level gives way to the third and jumps between them
from run to run, the 95th inside the third."""
from bench.harness.window import percentile


def read(run):
    g = run.window["gaps"]
    return percentile(g, 95) if g else None
