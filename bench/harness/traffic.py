"""The one traffic generator: sessions of turns, drawn from a traffic
file's parameters and a seed.

A traffic file (``bench/traffic/<name>.json``) describes sessions:

* ``arrival``: ``{"process": "poisson", "rate_per_s": r}`` (open loop:
  sessions start at exponential gaps) or ``{"process": "at_start",
  "count": n}`` (every session due at time 0);
* ``system_prompt``: tokens every session starts with, shared by all;
* ``first_input``, ``turns``, ``next_input``, ``output``, ``gap_s``:
  distributions (below) of a session's own first context, its number of
  model turns, the tokens appended before each later turn (a tool result
  or a user's next message), each turn's output tokens, and the
  closed-loop gap from a turn's last token to the next turn's arrival;
* ``tool_calls``: whether the gaps are announced tool runs (the agent
  setting: each turn but the last ends in a tool call);
* ``warm_s``, ``drain_s``: seconds of the same traffic served before the
  measured window (set-up the traffic needs), and the most the run goes
  on past the window's end for requests that arrived in it.

Distributions: ``{"dist": "uniform", "lo", "hi"}`` (integers, or floats
for ``gap_s``), ``{"dist": "lognormal", "median", "sigma", "lo", "hi"}``
(clipped), ``{"dist": "exponential", "mean"}``.

Every seed draws the same work, in an order of its own.  Each quantity
(the Poisson gaps, and each size) is cut into runs of ``BLOCK``
consecutive values, sessions or turns; each run holds the distribution's
quantiles ``(i + 0.5) / BLOCK`` once each, in an order drawn from the
seed.  Inside a run short gaps cluster and long requests bunch, as in a
random stream, and another seed is another schedule; across runs the
amount of work stays that of the distribution, so a window of some
hundred requests holds about the same work on every seed.  Independent
draws would make the work itself differ from seed to seed: on the
server's model clock (``bench/rehearse.py``, no timing noise) they
spread the chat mix's TTFT p90 by 36-50% and its tokens/s by 10-20%
between seeds (quartile spread over 12 seeds); a permutation of one set
over the whole run, 29% and 6%; runs of 32, 18.5% and 2.5% (the batch
mix's tokens/s: 9.5% permuted whole, 1.3% in runs of 32).  The seed also
draws the token ids (and, in ``weights.py``, the weights).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Turn:
    output: np.ndarray        # forced output tokens of the turn (int32)
    next_input: np.ndarray    # appended after it, before the next turn
    gap_s: float              # its last token to the next turn's arrival


@dataclass
class Session:
    sid: int
    arrival: float            # the first turn's arrival (seconds)
    history0: np.ndarray      # system prompt + the session's first input
    turns: List[Turn]


def load(path) -> Dict:
    return json.loads(Path(path).read_text())


def _quantiles(spec: Dict, q: np.ndarray) -> np.ndarray:
    """The distribution ``spec`` at the quantiles ``q`` (in (0, 1))."""
    kind = spec["dist"]
    if kind == "uniform":
        lo, hi = spec["lo"], spec["hi"]
        if isinstance(lo, int) and isinstance(hi, int):
            return np.minimum(lo + np.floor(q * (hi - lo + 1)), hi)
        return lo + q * (hi - lo)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        v = spec["median"] * np.exp(spec["sigma"] * z)
        return np.clip(np.round(v), spec["lo"], spec["hi"])
    if kind == "exponential":
        return -spec["mean"] * np.log1p(-q)
    raise ValueError(f"unknown distribution {kind!r}")


BLOCK = 32


def draw(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values of ``spec``: each run of ``BLOCK`` consecutive values
    holds the distribution's quantiles ``(i + 0.5) / BLOCK`` once each,
    in an order drawn from ``rng``."""
    i = np.arange(n)
    size = np.minimum(BLOCK, n - i // BLOCK * BLOCK)
    vals = _quantiles(spec, (i % BLOCK + 0.5) / size)
    return vals[np.argsort(i // BLOCK + rng.random(n), kind="stable")]


def generate(traffic: Dict, seed: int, vocab: int,
             horizon_s: float, rate_per_s: Optional[float] = None
             ) -> List[Session]:
    """The sessions of one run: every session that arrives before
    ``horizon_s`` (the window's end).  ``rate_per_s`` overrides the file's
    Poisson rate (the knee sweep)."""
    traffic = dict(traffic)
    if rate_per_s is not None:
        traffic["arrival"] = dict(traffic["arrival"], rate_per_s=rate_per_s)
    rng = np.random.default_rng(seed)
    arr = traffic["arrival"]
    if arr["process"] == "at_start":
        starts = np.zeros(int(arr["count"]))
    else:
        # the mean count over the horizon, at gaps that sum to it
        n = max(int(round(arr["rate_per_s"] * horizon_s)), 1)
        gaps = draw({"dist": "exponential", "mean": 1.0}, n + 1, rng)
        starts = np.cumsum(gaps)[:n] * (horizon_s / gaps.sum())
    n = len(starts)
    n_turns = draw(traffic["turns"], n, rng).astype(int)
    first = draw(traffic["first_input"], n, rng).astype(int)
    total = int(n_turns.sum())
    outs = draw(traffic["output"], total, rng).astype(int)
    # a session's last turn has no next input and no gap after it
    nxt = draw(traffic["next_input"], total - n, rng).astype(int)
    gaps = draw(traffic["gap_s"], total - n, rng)
    tok = lambda k: rng.integers(2, vocab, size=int(k), dtype=np.int32)
    system = tok(traffic.get("system_prompt", 0))
    sessions, j, k = [], 0, 0
    for sid in range(n):
        turns = []
        for i in range(n_turns[sid]):
            last = i == n_turns[sid] - 1
            turns.append(Turn(output=tok(outs[j]),
                              next_input=tok(0 if last else nxt[k]),
                              gap_s=0.0 if last else float(gaps[k])))
            j += 1
            k += 0 if last else 1
        sessions.append(Session(
            sid=sid, arrival=float(starts[sid]),
            history0=np.concatenate([system, tok(first[sid])]),
            turns=turns))
    return sessions
