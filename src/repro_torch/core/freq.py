"""Piecewise-exponential frequency function (paper §4.4, Eq. 9).

    f_B(t) = min( exp(-τ_B(t)/α),  exp(-(τ_B(t)-τ0)/β) ),   τ_B(t) = t - a_B

Only exponentials satisfy the order-preserving rule (Eq. 8 / Appendix A), so
*within each segment* the relative order of ``f_B(t)·ΔT_B`` between blocks is
time-invariant.  That lets each segment's weights live in a balanced tree
keyed by a **time-independent key**:

    w1(t) = exp(-(t-a)/α)·c·ΔT = exp( a/α + ln c + ln ΔT ) · exp(-t/α)
    w2(t) = exp(-(t-a-τ0)/β)·c·ΔT = exp( (a+τ0)/β + ln c + ln ΔT ) · exp(-t/β)

so ``key1 = a/α + ln(c·ΔT)`` and ``key2 = (a+τ0)/β + ln(c·ΔT)`` order the
trees for *any* t.  We keep everything in log space (`a/α` grows unboundedly
with wall-clock time, so materializing exp(key) would overflow).

``c`` is an optional EWMA hit-count multiplier (the LFU part: "historical
access frequency with exponential weight decay", §4.2).  It is constant while
a block sits in the tree, so order preservation is intact.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class FreqParams:
    """The Eq.-9 piecewise-exponential frequency function (paper §4.4)
    and its time-invariant tree keys (Eq. 8 / Appendix A: only
    exponentials preserve pairwise weight order over time, which is what
    licenses Algorithm 1's balanced trees).  ``key1``/``key2`` are the
    per-segment log-space keys; ``log_w1``/``log_w2`` evaluate a key's
    current weight at EVICT time; ``log_lambda_for_lifespan`` is the
    Eq.-10 online adaptation.  Derived from the three user-facing
    hyper-parameters (paper §6.4):

    * ``lifespan``      — X of the turning point (e.g. P99 reuse interval)
    * ``reuse_prob``    — Y of the turning point (frequency value there)
    * ``slope_ratio``   — |slope₂|/|slope₁| at the turning point (paper: 40)
    """
    alpha: float
    beta: float
    tau0: float
    lifespan: float
    reuse_prob: float
    slope_ratio: float

    @staticmethod
    def from_turning_point(lifespan: float, reuse_prob: float = 0.5,
                           slope_ratio: float = 40.0) -> "FreqParams":
        assert 0.0 < reuse_prob < 1.0 and slope_ratio > 1.0 and lifespan > 0
        ln_inv_p = -math.log(reuse_prob)
        alpha = lifespan / ln_inv_p
        # slope ratio at turning point = (w/β)/(w/α) = α/β
        beta = alpha / slope_ratio
        # continuity: exp(-(lifespan - tau0)/beta) = reuse_prob
        tau0 = lifespan - beta * ln_inv_p
        return FreqParams(alpha=alpha, beta=beta, tau0=tau0,
                          lifespan=lifespan, reuse_prob=reuse_prob,
                          slope_ratio=slope_ratio)

    # ---- direct evaluation (used by tests / O(n) baselines) -------------
    def log_f(self, tau: float) -> float:
        return min(-tau / self.alpha, -(tau - self.tau0) / self.beta)

    def f(self, tau: float) -> float:
        return math.exp(self.log_f(tau))

    # ---- time-invariant tree keys (log space) ----------------------------
    def key1(self, last_access: float, log_cost: float) -> float:
        return last_access / self.alpha + log_cost

    def key2(self, last_access: float, log_cost: float) -> float:
        return (last_access + self.tau0) / self.beta + log_cost

    # ---- evaluate a key's current log-weight ------------------------------
    def log_w1(self, key1: float, now: float) -> float:
        return key1 - now / self.alpha

    def log_w2(self, key2: float, now: float) -> float:
        return key2 - now / self.beta

    # ---- Eq. 10: online lifespan adaptation -------------------------------
    def log_lambda_for_lifespan(self, observed_tau: float) -> float:
        """ln λ that shifts the effective turning point to ``observed_tau``."""
        return (observed_tau - self.tau0) / self.beta - observed_tau / self.alpha


class EwmaCounter:
    """Exponentially-decayed hit counter — §4.2's "historical access
    frequency with exponential weight decay", the LFU multiplier c_B in
    the eviction weight f_B(t)·c_B·ΔT_B.  Constant while a block sits in
    a tree, so Eq. 8's order preservation is intact."""

    __slots__ = ("count", "last", "gamma")

    def __init__(self, gamma: float):
        self.count = 0.0
        self.last = 0.0
        self.gamma = gamma

    def hit(self, now: float) -> float:
        self.count = self.count * math.exp(-(now - self.last) / self.gamma) + 1.0
        self.last = now
        return self.count

    def value(self, now: float) -> float:
        return self.count * math.exp(-(now - self.last) / self.gamma)
