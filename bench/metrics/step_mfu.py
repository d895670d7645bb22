"""Model step, percent of the chip's bf16 peak: the routed model
operations of the steps dispatched in the window (``bench/harness/
flops.py``: two a parameter a row touches, the top-k experts only,
logits for sampled rows only, attention four a head dimension a visible
key, every layer at its window; the configuration's module may bring
its own counts) over the window's wall seconds times the peak."""
import math

from bench.harness.flops import step_flops


def read(run):
    wall = run.window["wall_s"]
    steps = run.window_steps()
    if not steps or not wall or math.isnan(wall):
        return None
    page = run.deployment["block_size"]
    total = sum(step_flops(w, run.model, page, run.reference)
                for w in steps)
    return 100.0 * total / (wall * run.peaks["bf16_flops"])
