"""Online lifespan estimation and λ adaptation (paper §5.1, Eq. 10).

A sliding window of observed block-reuse intervals feeds a periodic update

    λ_new = exp( (τ̂ − τ0)/β − τ̂/α )

which shifts the piecewise-exponential turning point to the detected
lifespan τ̂ with **zero** data-structure cost: λ is a scalar multiplier in
the EVICT comparison only (Algorithm 1, line 8).

The same percentile-over-sliding-window estimator, pointed at a different
interval population, drives the online frontend's *predictive host-tier
prefetch*: :class:`ResumePredictor` estimates how long a suspended agent
session will stay suspended (paper §5.2/§6.5, the Continuum integration),
so the session's KV blocks can be swapped back toward the device *before*
the predicted resume.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Optional

from repro_torch.core.freq import FreqParams


class LifespanTracker:
    """Online λ adaptation (paper §5.1, Eq. 10).

    Observes per-block reuse intervals (fed by the block manager), keeps a
    sliding window, and periodically re-derives ``ln λ`` so the effective
    turning point of the Eq.-9 frequency function tracks the workload's
    measured lifespan percentile.  The evictor consumes the scalar via
    ``EvictionPolicy.set_log_lambda`` — Algorithm 1's EVICT comparison is
    the only place λ appears, so adaptation is O(1)."""

    def __init__(self, freq: FreqParams, window: int = 512,
                 percentile: float = 0.99, update_every: int = 64):
        self.freq = freq
        self.window: Deque[float] = deque(maxlen=window)
        self.percentile = percentile
        self.update_every = update_every
        self._since_update = 0
        self.log_lambda = 0.0

    def observe_reuse(self, interval: float) -> Optional[float]:
        """Record a block-reuse interval; returns new ln λ when updated."""
        self.window.append(max(interval, 1e-9))
        self._since_update += 1
        if self._since_update < self.update_every or len(self.window) < 16:
            return None
        self._since_update = 0
        xs = sorted(self.window)
        idx = min(len(xs) - 1, int(self.percentile * len(xs)))
        tau_hat = xs[idx]
        self.log_lambda = self.freq.log_lambda_for_lifespan(tau_hat)
        return self.log_lambda


class ResumePredictor:
    """Suspend-duration estimator for predictive KV restoration (paper
    §5.2/§6.5 — the Continuum agent-serving integration; the frontend in
    ``repro.serving.frontend`` uses it to time host-tier prefetches).

    A tool-calling session announces an estimated tool duration (the
    Continuum TTL).  The predictor tracks the *error* between announced
    and actual suspend durations in a sliding window — the same
    percentile-window idiom as :class:`LifespanTracker` — and predicts

        resume ≈ suspend + announced + P_q(actual − announced)

    so a conservative quantile ``q`` makes the prefetch land early enough
    even when tools overrun their estimates.  For the paper's predictable
    tools the error window is all zeros and the prediction is exact.
    Suspensions with no announced duration fall back to a quantile of the
    observed absolute durations (``default`` until anything is observed).
    """

    def __init__(self, window: int = 128, percentile: float = 0.9,
                 default: float = 1.0):
        self.errors: Deque[float] = deque(maxlen=window)
        self.durations: Deque[float] = deque(maxlen=window)
        self.percentile = percentile
        self.default = default

    @staticmethod
    def _quantile(xs, q: float) -> float:
        ys = sorted(xs)
        return ys[min(len(ys) - 1, int(q * len(ys)))]

    def observe(self, actual: float,
                announced: Optional[float] = None) -> None:
        """Record one completed suspension (called at the actual resume)."""
        self.durations.append(max(actual, 0.0))
        if announced is not None:
            self.errors.append(actual - announced)

    def predict(self, announced: Optional[float] = None) -> float:
        """Predicted suspend duration for a session suspending now."""
        if announced is not None:
            corr = self._quantile(self.errors, self.percentile) \
                if self.errors else 0.0
            return max(announced + corr, 0.0)
        if self.durations:
            return self._quantile(self.durations, self.percentile)
        return self.default
