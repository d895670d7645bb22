"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady stretch of the window, and host spans around the calls into each
layer, recorded from the benchmark's side (the program has none yet).

The stretch starts a third of the way into the window (the server's
clock) and lasts ``STRETCH_S`` seconds of wall time (at most a third of
the window); the device is synchronised at its start and its end, so the
kernels it holds are those of the steps dispatched inside it.

From the trace: the device's busy time (the union of kernel intervals
inside the stretch), each kernel's time, the attention launches' time
(read by ``bench/metrics/attn_roofline.py``), and every idle gap
of the device with the host span that was open at its middle.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

STRETCH_S = 3.0
MARK = "bench.traced_stretch"

# (object attribute path, span name): the calls into each layer
SPANS = (("sched.schedule", "control_plane.schedule"),
         ("engine.build_inputs", "control_plane.assemble"),
         ("engine._step_impl", "model_step.enqueue"),
         ("_retire", "control_plane.retire"),
         ("_postprocess", "control_plane.postprocess"))


def _wrap(obj, attr: str, name: str) -> None:
    fn = getattr(obj, attr)

    def spanned(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    setattr(obj, attr, spanned)


def install_spans(server, source) -> None:
    for path, name in SPANS:
        *parents, attr = path.split(".")
        obj = server
        for p in parents:
            obj = getattr(obj, p)
        _wrap(obj, attr, name)
    _wrap(source, "pop_due", "frontend.pop_due")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    def __init__(self):
        self.prof = None
        self.mark = None
        self.wall: List[float] = []
        self.done = False
        self.events: Optional[Dict] = None

    def tick(self, now: float, window) -> None:
        begin = window.t0 + window.seconds / 3.0
        length = min(STRETCH_S, window.seconds / 3.0)
        if self.prof is None and not self.done and now >= begin:
            _sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.mark = torch.profiler.record_function(MARK)
            self.mark.__enter__()
            self.wall = [time.perf_counter()]
        elif self.prof is not None and not self.done \
                and time.perf_counter() >= self.wall[0] + length:
            _sync()
            self.wall.append(time.perf_counter())
            self.mark.__exit__(None, None, None)
            self.prof.stop()
            self.done = True
            self.events = _read(self.prof)
            self.prof = None

    def in_stretch(self, wall: float) -> bool:
        return len(self.wall) == 2 and self.wall[0] <= wall < self.wall[1]


def _read(prof) -> Dict:
    """Kernels (name, start, end) and host spans (name, start, end) in
    microseconds of the trace's clock, and the stretch's bounds."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    kernels, spans, mark = [], [], None
    names = {n for _, n in SPANS} | {"frontend.pop_due"}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        t0 = float(ev["ts"])
        t1 = t0 + float(ev.get("dur", 0.0))
        if cat == "kernel":
            kernels.append((name, t0, t1))
        elif name == MARK:
            mark = (t0, t1)
        elif name in names:
            spans.append((name, t0, t1))
    return {"kernels": kernels, "spans": spans, "mark": mark}


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarise(events: Dict) -> Optional[Dict]:
    """Busy and stretch seconds, the kernels clipped to the stretch, and
    the breakdown: the ten device operations that took most time and the
    ten longest idle gaps, each named by the host span open at its
    middle (``host.other`` where none of the benchmark's spans was)."""
    if not events or not events["mark"]:
        return None
    lo, hi = events["mark"]
    ks = [(n, max(a, lo), min(b, hi)) for n, a, b in events["kernels"]
          if b > lo and a < hi]
    if not ks:
        return None
    merged = _merge([(a, b) for _, a, b in ks])
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = {}
    for n, a, b in ks:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    spans = sorted(events["spans"], key=lambda s: s[1])
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[1] <= mid < s[2]]
        label = max(open_, key=lambda s: s[1])[0] if open_ else "host.other"
        named.append([label, (b - a) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": ks,
            "breakdown": {"device_ops": [[n, t * 1e-6] for n, t in top],
                          "idle_gaps": named}}
