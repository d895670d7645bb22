"""Spans and counters of the serving loop, kept in memory on the host's
clock (``time.perf_counter`` seconds), off by default.

``AsymCacheServer.enable_tracing()`` makes one :class:`Tracer` and hands it
to the scheduler and the engine for the server's life.  Without it, the
server attaches a tracer that follows a ``torch.profiler``: on from the
first loop iteration that begins while one records, off from the first
that begins while none does, so that a profile of the server carries its
spans (the benchmark's traced stretch reads them).
``AsymCacheServer.trace_export()`` hands out what was recorded.  With no
tracer attached every hook is one ``None`` check, each loop iteration asks
once whether a profiler records, and the loop reads no clock and enters
no profiler range that it did not before.

A span is (name, start, end, parent, step id), in preallocated columns of
``capacity`` rows; past them ``spans_dropped`` counts what was lost.  One
tree a dispatching loop iteration of ``serve`` (iterations that dispatch
nothing, an idle jump or a retry, fold into the next that does), and the
metric of the benchmark (``bench/metrics/<name>.py``) that reads each:

| span or counter | where | read by |
| --- | --- | --- |
| ``step`` (root) | a loop iteration of ``serve`` that dispatches | ``host_busy_ms`` |
| ``poll`` | ``source.pop_due``, ``_on_arrival``, ``_preflight``, ``_sweep_deadlines``, ``unpin_expired`` | ``host_busy_ms``, ``idle_control_plane_ms`` |
| ``schedule`` | ``ChunkingScheduler.schedule`` | ``idle_control_plane_ms`` |
| ``admit`` (in ``schedule``) | its admission scan | ``admission_ms``, ``idle_control_plane_ms`` |
| ``assemble`` | ``Engine.build_inputs`` in ``Engine.dispatch`` | ``idle_control_plane_ms`` |
| ``enqueue`` | the ``Engine._step_impl`` call in ``Engine.dispatch`` | ``enqueue_ms`` |
| ``postprocess`` | ``AsymCacheServer._postprocess`` | ``host_busy_ms`` |
| ``retire`` | ``AsymCacheServer._retire`` | ``host_busy_ms`` |
| ``wait`` (in ``retire``, or the step itself at depth 0) | the blocking fetch of a step's ids and logit rows | ``host_busy_ms`` (left out) |
| ``admit_tries``, ``admitted`` | the scheduler's counters (always on), per step | ``admit_yield`` |

The ``schedule`` and ``assemble`` spans share their clock reads with
``control_plane_time`` and ``StepHandle.assembly_time``.  Each step's row
(``export()["steps"]``) holds its root span, the server's ``now`` when it
dispatched, ``t_bucket``, its prefill and decode rows, ``k``, its
admission counts and ``cut``: 1 where a profiler started or stopped
inside the step (its time then holds the profiler's own start or stop).

While a ``torch.profiler`` records, every span also enters
``torch.profiler.record_function("repro.<name>")``, the engine puts a
``repro.attn`` and a ``repro.moe`` (or ``repro.mlp``) range around each
layer's attention and feed-forward (a kernel launched in one belongs to
that part of the layer), and each step begins with a ``repro.anchor`` range whose clock read is kept
(``anchors``): :func:`clock_map` maps the in-memory spans onto the
profiler's clock with them.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PREFIX = "repro."
ANCHOR = PREFIX + "anchor"
# the context of a layer range while no profiler records (reusable)
NO_RANGE = nullcontext()

# the step table's columns
STEP_FIELDS = (("span", np.int32), ("now", np.float64),
               ("t_bucket", np.int32), ("prefill_rows", np.int32),
               ("decode_rows", np.int32), ("k", np.int32),
               ("admit_tries", np.int32), ("admitted", np.int32),
               ("cut", np.int8))


class Tracer:
    def __init__(self, capacity: int = 1 << 18, follows: bool = False):
        self.capacity = capacity
        # attached only while a profiler records (AsymCacheServer)
        self.follows = follows
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}
        self.name = np.zeros(capacity, np.int16)
        self.t0 = np.zeros(capacity)
        self.t1 = np.full(capacity, np.nan)
        self.parent = np.zeros(capacity, np.int32)
        self.step = np.zeros(capacity, np.int32)
        self.n = 0
        self.spans_dropped = 0
        self.steps = {k: np.zeros(capacity, dt) for k, dt in STEP_FIELDS}
        self.n_steps = 0
        self.anchors: List[float] = []
        self.profiling = False
        # the open spans (row, or -1 where dropped) and their profiler
        # ranges (None where no profiler recorded at the open)
        self._stack: List[int] = []
        self._ranges: List = []
        self._sid = -1             # the open tree's step id (-1: none)
        self._root = -1            # its root span's row (-1: dropped)
        self._was_profiling = False   # a profiler recorded at its open
        self._counts = (0, 0)      # admission counters at the last step

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    # -- spans ----------------------------------------------------------
    def open(self, name: str) -> float:
        """Open a span under the innermost open one and return its start,
        the clock read just after its profiler range is entered (the
        caller may time its own work from it)."""
        profiling = torch.autograd._profiler_enabled()
        if profiling and not self.profiling:
            # a profiler has started: mark its clock (the first range it
            # records is late, and this one takes that cost)
            self._anchor()
        self.profiling = profiling
        rng = None
        if self.profiling:
            rng = torch.profiler.record_function(PREFIX + name)
            rng.__enter__()
        t = time.perf_counter()
        i = self.n
        if i < self.capacity:
            self.n = i + 1
            self.name[i] = self._id(name)
            self.t0[i] = t
            self.t1[i] = np.nan
            self.parent[i] = self._stack[-1] if self._stack else -1
            self.step[i] = self._sid
        else:
            i = -1
            self.spans_dropped += 1
        self._stack.append(i)
        self._ranges.append(rng)
        return t

    def close(self) -> float:
        """Close the innermost open span and return its end, the clock
        read just after its profiler range is left."""
        i = self._stack.pop()
        rng = self._ranges.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        t = time.perf_counter()
        if i >= 0:
            self.t1[i] = t
        return t

    # -- step trees -----------------------------------------------------
    def open_step(self) -> None:
        """Open a step tree, unless the iterations before dispatched
        nothing and one is open still; mark the profiler's clock."""
        if self._sid >= 0:
            return
        self._sid = self.n_steps
        self.open("step")
        self._root = self._stack[-1]
        self._was_profiling = self.profiling
        if self.profiling:
            self._anchor()

    def _anchor(self) -> None:
        """A ``repro.anchor`` range and the clock read just inside it,
        as a span's start is read."""
        with torch.profiler.record_function(ANCHOR):
            self.anchors.append(time.perf_counter())

    def resume(self, admit_tries: int, admitted: int) -> None:
        """Count each step's admissions from these running totals of the
        scheduler's on (the tracer is attached)."""
        self._counts = (admit_tries, admitted)

    def dispatched(self, now: float, plan, admit_tries: int,
                   admitted: int) -> None:
        """The open step dispatches ``plan`` at the server's ``now``;
        the counters are the scheduler's running totals."""
        j = self.n_steps
        self.n_steps = j + 1
        tries0, admitted0 = self._counts
        self._counts = (admit_tries, admitted)
        if j >= self.capacity:
            return
        row = {"span": self._root, "now": now,
               "t_bucket": -1 if plan.t_bucket is None else plan.t_bucket,
               "prefill_rows": sum(len(c.positions) for c in plan.prefills),
               "decode_rows": len(plan.decodes), "k": plan.decode_steps,
               "admit_tries": admit_tries - tries0,
               "admitted": admitted - admitted0,
               "cut": int(self.profiling != self._was_profiling)}
        for k, v in row.items():
            self.steps[k][j] = v

    def close_step(self) -> None:
        self.close()
        if self._sid < min(self.n_steps, self.capacity) and \
                torch.autograd._profiler_enabled() != self._was_profiling:
            self.steps["cut"][self._sid] = 1
        self._sid = -1

    def discard(self) -> None:
        """End the open tree: one that dispatched nothing is dropped, one
        that a raise left open is closed now."""
        if self._sid < 0:
            return
        keep = self.n_steps > self._sid
        while self._stack:
            self.close()
        if not keep and self._root >= 0:
            self.n = self._root
        self._sid = -1

    def export(self) -> Dict:
        """The recorded spans and steps (copies), the anchors' clock
        reads and the drop count."""
        n, m = self.n, min(self.n_steps, self.capacity)
        return {"clock": "perf_counter", "prefix": PREFIX,
                "names": list(self.names),
                "name": self.name[:n].copy(), "t0": self.t0[:n].copy(),
                "t1": self.t1[:n].copy(), "parent": self.parent[:n].copy(),
                "step": self.step[:n].copy(),
                "steps": {k: v[:m].copy() for k, v in self.steps.items()},
                "anchors": np.asarray(self.anchors),
                "spans_dropped": self.spans_dropped}


def clock_map(anchors: Sequence[float], trace_us: Sequence[float]
              ) -> Optional[Tuple[float, float]]:
    """(slope, offset) with ``trace_us ≈ slope * 1e6 * t + offset`` for a
    ``perf_counter`` read ``t``: the anchors' reads against their
    ``repro.anchor`` ranges' starts in a profiler trace (microseconds),
    paired in order.  Medians, so that a range entered late (the thread
    preempted between the read and the range) moves nothing.  None with
    no pair."""
    n = min(len(anchors), len(trace_us))
    if n == 0:
        return None
    x = 1e6 * np.asarray(anchors[:n], np.float64)
    y = np.sort(np.asarray(trace_us, np.float64))[:n]
    slope = 1.0
    h = n // 2
    if h >= 2 and x[-1] - x[0] > 1e5:
        dx = x[h:2 * h] - x[:h]
        ok = dx > 0
        if ok.any():
            slope = float(np.median((y[h:2 * h] - y[:h])[ok] / dx[ok]))
    return slope, float(np.median(y - slope * x))
