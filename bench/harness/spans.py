"""The program's own spans, as the per-layer metrics read them.

``AsymCacheServer.trace_export()`` (``repro_torch/serving/tracing.py``)
hands out the serving loop's spans on the host's clock (``perf_counter``
seconds), one tree a dispatched step, and each step's row: the server's
``now`` at dispatch, the admission counts and ``cut`` (a profiler started
or stopped inside the step).  The program records them while a profiler
records, so a ``--trace 1`` run holds the steps of its traced stretch.

``Run`` keeps neither the server nor the stretch's own clock reads; the
``Window`` that served the run holds both (``server``, ``tracer``), and
each request's token listener is that window's bound ``on_token``
(:func:`served_by`).  A program without the tracer, or a run with no
window to reach, gives None, and every reader here then returns None.

* :func:`window`: the window's whole steps (``now`` in ``[t0, t1)``, the
  set of ``Run.window_steps()``, ``cut`` ones left out), each with its
  duration, its spans' time by name (``wait``, ``admit``, ``enqueue``
  ...) and its self time.
* :func:`idle_by_span`: the device's idle gaps in the traced stretch,
  each put down whole to the innermost program span open at its middle,
  the spans mapped onto the profiler's clock by the stretch's own two
  clock reads (``trace.Tracer.wall``, read just inside the stretch's
  ``mark`` range).
* :func:`report`: the spans' coverage and consistency in the window and
  the stretch (``bench/spans_report.py`` prints it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# the spans whose device-idle time is the control plane's
CONTROL_PLANE = ("poll", "schedule", "admit", "assemble")
SPANS = ("poll", "schedule", "admit", "assemble", "enqueue", "postprocess",
         "retire", "wait")


def served_by(run):
    """The window that served ``run`` (the owner of its requests' token
    listener), or None."""
    for req in run.requests:
        w = getattr(getattr(req, "on_token", None), "__self__", None)
        if w is not None and hasattr(w, "server") and hasattr(w, "tracer"):
            return w
    return None


def export(run) -> Optional[Dict]:
    """The program's ``trace_export()``, or None (no such program, no
    window, nothing recorded)."""
    w = served_by(run)
    fn = getattr(getattr(w, "server", None), "trace_export", None)
    ex = fn() if callable(fn) else None
    if ex is None or not len(ex["steps"]["span"]):
        return None
    return ex


def _names(ex: Dict) -> np.ndarray:
    return np.asarray(ex["names"] + [""])[ex["name"]]


def steps(ex: Dict) -> Dict[str, np.ndarray]:
    """One row a recorded step: ``now``, ``dur``, the time of its spans
    by name (every depth: ``wait`` inside ``retire`` counts as
    ``wait``), ``self`` (the root's time outside its children), the
    admission counts and ``cut``."""
    st = ex["steps"]
    ok = st["span"] >= 0
    root = st["span"][ok]
    n = len(st["span"])
    dur = ex["t1"] - ex["t0"]
    out = {"now": st["now"][ok], "dur": dur[root],
           "admit_tries": st["admit_tries"][ok],
           "admitted": st["admitted"][ok], "cut": st["cut"][ok]}
    names = _names(ex)
    mine = ex["step"] >= 0
    for name in set(ex["names"]) - {"step"}:
        sel = mine & (names == name)
        out[name] = np.bincount(ex["step"][sel], weights=dur[sel],
                                minlength=n)[ok]
    kids = mine & (ex["parent"] >= 0) & (names != "step")
    kids &= np.isin(ex["parent"], root)
    direct = np.bincount(ex["step"][kids], weights=dur[kids], minlength=n)
    out["self"] = out["dur"] - direct[ok]
    return out


def window(run, ex: Optional[Dict] = None
           ) -> Optional[Dict[str, np.ndarray]]:
    """The window's whole steps (:func:`steps`, rows with ``now`` in
    ``[t0, t1)`` and ``cut`` 0); every span name a step may lack reads
    0.  None without spans or such steps."""
    ex = export(run) if ex is None else ex
    if ex is None:
        return None
    st = steps(ex)
    sel = (st["now"] >= run.t0) & (st["now"] < run.t1) & (st["cut"] == 0)
    if not sel.any():
        return None
    out = {k: v[sel] for k, v in st.items()}
    zero = np.zeros(int(sel.sum()))
    for name in SPANS:
        out.setdefault(name, zero)
    return out


def innermost(points: Sequence[float],
              intervals: Sequence[Tuple[float, float]]) -> List[int]:
    """For each point, the index of the innermost interval that holds it
    (``start <= x < end``; intervals nested as a stack's), or -1."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1]))
    out = [-1] * len(points)
    stack: List[int] = []
    k = 0
    for p in sorted(range(len(points)), key=points.__getitem__):
        x = points[p]
        while k < len(order) and intervals[order[k]][0] <= x:
            stack.append(order[k])
            k += 1
        while stack and intervals[stack[-1]][1] <= x:
            stack.pop()
        if stack:
            out[p] = stack[-1]
    return out


def gaps(kernels: Sequence[Tuple[str, float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretch's device-idle intervals: ``[lo, hi]`` less the union
    of the kernels' intervals (microseconds)."""
    merged: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for _, a, b in kernels
                       if b > lo and a < hi):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_by_span(run, ex: Optional[Dict] = None
                 ) -> Optional[Dict[str, float]]:
    """Seconds of device-idle time in the traced stretch by the innermost
    program span open at each gap's middle (``outside``: none open).
    None without a stretch or spans."""
    w = served_by(run)
    tracer = getattr(w, "tracer", None)
    events = getattr(tracer, "events", None)
    wall = getattr(tracer, "wall", None)
    if run.trace is None or not events or not events.get("mark") \
            or wall is None or len(wall) != 2:
        return None
    ex = export(run) if ex is None else ex
    if ex is None:
        return None
    # the stretch's ends on both clocks: each clock read lies just
    # inside the mark range, so the map is exact to a few microseconds
    (lo, hi), (w0, w1) = events["mark"], wall
    scale = (hi - lo) / (w1 - w0)
    t0 = lo + (ex["t0"] - w0) * scale
    t1 = lo + (ex["t1"] - w0) * scale
    sel = (t1 > lo) & (t0 < hi)
    names = _names(ex)[sel]
    idle = gaps(events["kernels"], lo, hi)
    at = innermost([0.5 * (a + b) for a, b in idle],
                   list(zip(t0[sel], t1[sel])))
    out: Dict[str, float] = {}
    for (a, b), i in zip(idle, at):
        key = str(names[i]) if i >= 0 else "outside"
        out[key] = out.get(key, 0.0) + (b - a) * 1e-6
    return out


def report(run) -> Optional[Dict]:
    """The spans' coverage and consistency in the window and the
    stretch, and the window's mean step by span (milliseconds)."""
    ex = export(run)
    w = window(run, ex)
    if w is None:
        return None
    out: Dict = {"spans_dropped": int(ex["spans_dropped"]),
                 "window_steps": int(len(w["dur"]))}
    wall = run.window.get("wall_s")
    if wall and not np.isnan(wall):
        out["step_cover"] = float(w["dur"].sum() / wall)
    out["self_share"] = float(np.mean(w["self"] / w["dur"]))
    cp = run.window["delta"].get("control_plane_time")
    if cp:
        out["cp_spans_over_counter"] = float(
            (w["schedule"].sum() + w["assemble"].sum()) / cp)
    out["step_ms"] = {k: 1e3 * float(np.mean(w[k]))
                      for k in ("dur", "self") + SPANS}
    out["admit_tries"] = int(w["admit_tries"].sum())
    out["admitted"] = int(w["admitted"].sum())
    idle = idle_by_span(run, ex)
    if idle is not None:
        total = sum(idle.values())
        out["idle_by_span_s"] = idle
        out["idle_span_open_share"] = (
            1.0 - idle.get("outside", 0.0) / total) if total > 0 else None
        out["stretch_steps"] = len(run.trace["steps"])
    return out
