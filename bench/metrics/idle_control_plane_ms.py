"""Control plane, milliseconds a step: the device's idle time in the
traced stretch whose innermost open program span is ``poll``,
``schedule``, ``admit`` or ``assemble`` (each idle gap put down whole to
the span open at its middle, ``bench/harness/spans.py``), over the steps
dispatched in the stretch."""
from bench.harness import spans


def read(run):
    t = run.trace
    if t is None or not t["steps"]:
        return None
    idle = spans.idle_by_span(run)
    if idle is None:
        return None
    return 1e3 * sum(idle.get(n, 0.0) for n in spans.CONTROL_PLANE) \
        / len(t["steps"])
