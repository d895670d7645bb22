"""KV-block eviction policies (paper §4.2, §4.4, Algorithm 1).

All policies share one interface over *evictable* blocks (ref-count 0 and
unpinned).  The block manager calls ``add`` when a block becomes evictable,
``remove`` when it is reused (cache hit) or force-freed, and ``evict`` when
it needs a victim.

Blocks referenced by any live request — including blocks shared across
requests via cross-request prefix sharing (refcount > 1) — are never in
the evictable set at all, so no policy can victimize them.  Shared-block
savings still reach the objective: when a previously shared block finally
becomes evictable, the block manager folds its peak concurrent sharer
count into ``EvictableMeta.log_cost`` (evicting it would forfeit that many
requests' worth of recompute savings).

Policies:
  * ``AsymCacheEvictor``        — Algorithm 1: two treaps, O(log n)
  * ``AsymCacheLinearEvictor``  — identical weights, O(n) scan (Table 2 ablation)
  * ``LRUEvictor``              — vLLM-style prefix-cache LRU
  * ``MaxScoreEvictor``         — [50]-style reuse-probability score, O(n)
  * ``PensieveEvictor``         — inverse-proportional frequency × cost, O(n)
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.freq import FreqParams
from repro_torch.core.treap import Treap


@dataclass
class EvictableMeta:
    """Per-block eviction inputs (paper §4.2): the last-access time that
    seeds the Eq.-9 frequency term, ``log_cost`` = ln ΔT_B — the Eq.-7
    marginal recomputation cost of the block at its positional index
    (computed by ``CostModel.log_block_cost``, with sharing/boost factors
    folded in by the block manager) — and the exponentially-decayed hit
    count (the LFU multiplier of §4.2)."""
    last_access: float
    log_cost: float        # ln ΔT_B (position-aware recompute cost)
    count: float = 1.0     # EWMA hit count (≥ small positive)


class EvictionPolicy:
    """Interface over the evictable set (paper §4.2): every policy ranks
    ref-count-0, unpinned blocks by some priority and surrenders the
    minimum on ``evict``.  AsymCache's priority is the expected
    recomputation latency f_B(t)·ΔT_B (Eq. 9 × Eq. 7); the baselines
    drop one or both factors."""
    name = "base"

    def add(self, block_id: int, meta: EvictableMeta) -> None:
        raise NotImplementedError

    def remove(self, block_id: int) -> bool:
        raise NotImplementedError

    def evict(self, now: float) -> Optional[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __contains__(self, block_id: int) -> bool:
        raise NotImplementedError

    def set_log_lambda(self, v: float) -> None:  # online lifespan (§5.1)
        pass


# ---------------------------------------------------------------------------
# AsymCache (Algorithm 1)
# ---------------------------------------------------------------------------

class AsymCacheEvictor(EvictionPolicy):
    """Algorithm 1 (paper §4.4–4.5): the O(log n) expected-latency
    evictor.  The weight w_B(t) = f_B(t)·c_B·ΔT_B uses the Eq.-9
    piecewise-exponential frequency, whose two segments each satisfy the
    order-preserving rule (Eq. 8 / Appendix A) — so each segment's
    ranking lives in its own balanced tree (``bt1``/``bt2``, treaps)
    under a **time-independent** key (``FreqParams.key1``/``key2``), and
    EVICT (Algorithm 1, line 8) compares just the two tree minima at the
    current time, with ln λ (Eq. 10, online lifespan) biasing the second
    segment.  add/remove/evict are all O(log n) — the Table-2 complexity
    claim."""

    name = "asymcache"

    def __init__(self, freq: FreqParams, use_hit_count: bool = True, seed: int = 0):
        self.freq = freq
        self.use_hit_count = use_hit_count
        self.bt1 = Treap(seed)
        self.bt2 = Treap(seed + 1)
        self._keys: Dict[int, Tuple[float, float]] = {}
        self.log_lambda = 0.0
        # deterministic op counts (benchmarks/control_plane_stress.py):
        # tree work itself is bt1.n_ops + bt2.n_ops
        self.n_adds = 0
        self.n_removes = 0
        self.n_evicts = 0

    def _log_cost(self, meta: EvictableMeta) -> float:
        lc = meta.log_cost
        if self.use_hit_count:
            lc += math.log(max(meta.count, 1e-9))
        return lc

    def add(self, block_id: int, meta: EvictableMeta) -> None:
        assert block_id not in self._keys
        self.n_adds += 1
        lc = self._log_cost(meta)
        k1 = self.freq.key1(meta.last_access, lc)
        k2 = self.freq.key2(meta.last_access, lc)
        self._keys[block_id] = (k1, k2)
        self.bt1.insert(k1, block_id)
        self.bt2.insert(k2, block_id)

    def remove(self, block_id: int) -> bool:
        keys = self._keys.pop(block_id, None)
        if keys is None:
            return False
        self.n_removes += 1
        self.bt1.delete(keys[0], block_id)
        self.bt2.delete(keys[1], block_id)
        return True

    def evict(self, now: float) -> Optional[int]:
        self.n_evicts += 1
        m1 = self.bt1.min()
        m2 = self.bt2.min()
        if m1 is None and m2 is None:
            return None
        lw1 = self.freq.log_w1(m1[0], now) if m1 else math.inf
        lw2 = (self.freq.log_w2(m2[0], now) + self.log_lambda) if m2 else math.inf
        victim = m1[1] if lw1 <= lw2 else m2[1]
        self.remove(victim)
        return victim

    def set_log_lambda(self, v: float) -> None:
        self.log_lambda = v

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._keys

    def log_weight(self, block_id: int, now: float) -> float:
        """Current log eviction weight of a block (tests/benchmarks)."""
        k1, k2 = self._keys[block_id]
        return min(self.freq.log_w1(k1, now),
                   self.freq.log_w2(k2, now) + self.log_lambda)


class AsymCacheLinearEvictor(EvictionPolicy):
    """The Table-2 ablation (paper §6.1): the identical Eq.-9 × Eq.-7
    weight w_B(t) = f_B(t)·c_B·ΔT_B, evaluated by brute force — an O(n)
    scan per eviction instead of Algorithm 1's two-treap O(log n).
    Decision-identical to :class:`AsymCacheEvictor` (tested); only the
    complexity differs, which is what `benchmarks/evictor_complexity.py`
    measures."""

    name = "asymcache-on"

    def __init__(self, freq: FreqParams, use_hit_count: bool = True):
        self.freq = freq
        self.use_hit_count = use_hit_count
        self._meta: Dict[int, EvictableMeta] = {}
        self.log_lambda = 0.0

    def add(self, block_id: int, meta: EvictableMeta) -> None:
        self._meta[block_id] = meta

    def remove(self, block_id: int) -> bool:
        return self._meta.pop(block_id, None) is not None

    def _log_weight(self, meta: EvictableMeta, now: float) -> float:
        lc = meta.log_cost
        if self.use_hit_count:
            lc += math.log(max(meta.count, 1e-9))
        tau = now - meta.last_access
        lf = min(-tau / self.freq.alpha,
                 -(tau - self.freq.tau0) / self.freq.beta + self.log_lambda)
        return lf + lc

    def evict(self, now: float) -> Optional[int]:
        best, best_w = None, math.inf
        for bid, meta in self._meta.items():          # O(n) scan
            w = self._log_weight(meta, now)
            if w < best_w:
                best, best_w = bid, w
        if best is not None:
            del self._meta[best]
        return best

    def set_log_lambda(self, v: float) -> None:
        self.log_lambda = v

    def __len__(self) -> int:
        return len(self._meta)

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._meta


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

class LRUEvictor(EvictionPolicy):
    """vLLM-style block-level LRU — the paper's primary baseline (§6.1,
    "vLLM-LRU" in Figs. 11/12/15): recency only, no recompute-cost or
    frequency terms (equivalently Eq. 9 with a single segment and
    ΔT_B ≡ 1)."""

    name = "lru"

    def __init__(self, prefer_shallow: bool = True):
        # vLLM tie-breaks equal-recency blocks by *longest prefix first*
        # (deeper blocks evicted before shallower ones); we order purely by
        # insertion recency which matches its observable behaviour for our
        # workloads.
        self._od: "OrderedDict[int, float]" = OrderedDict()

    def add(self, block_id: int, meta: EvictableMeta) -> None:
        self._od[block_id] = meta.last_access
        self._od.move_to_end(block_id)

    def remove(self, block_id: int) -> bool:
        return self._od.pop(block_id, None) is not None

    def evict(self, now: float) -> Optional[int]:
        if not self._od:
            return None
        bid, _ = self._od.popitem(last=False)
        return bid

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._od


class MaxScoreEvictor(EvictionPolicy):
    """Baseline (paper §6.1, the ATC'25 [50]-style "MaxScore"): evicts
    by minimal estimated reuse probability — the Eq.-9 frequency f_B(t)
    times the decayed hit count — while IGNORING the Eq.-7 recompute
    cost ΔT_B entirely.  O(n) scan; isolates how much of AsymCache's win
    comes from the cost term."""

    name = "maxscore"

    def __init__(self, freq: FreqParams):
        self.freq = freq
        self._meta: Dict[int, EvictableMeta] = {}

    def add(self, block_id: int, meta: EvictableMeta) -> None:
        self._meta[block_id] = meta

    def remove(self, block_id: int) -> bool:
        return self._meta.pop(block_id, None) is not None

    def evict(self, now: float) -> Optional[int]:
        best, best_p = None, math.inf
        for bid, meta in self._meta.items():          # O(n)
            logp = self.freq.log_f(now - meta.last_access) + math.log(
                max(meta.count, 1e-9))
            if logp < best_p:
                best, best_p = bid, logp
        if best is not None:
            del self._meta[best]
        return best

    def __len__(self) -> int:
        return len(self._meta)

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._meta


class PensieveEvictor(EvictionPolicy):
    """Baseline (paper §6.1, Pensieve [55]): suffix-preferring —
    inverse-proportional frequency 1/(1+τ/α) times the Eq.-7 positional
    cost.  The hyperbolic frequency violates the order-preserving rule
    (Eq. 8 / Appendix A: only exponentials keep pairwise order
    time-invariant), so no balanced-tree speedup exists and eviction is
    O(n) — the paper's argument for why Eq. 9 must be
    piecewise-EXPONENTIAL."""

    name = "pensieve"

    def __init__(self, freq: FreqParams):
        self.tau_scale = freq.lifespan
        self._meta: Dict[int, EvictableMeta] = {}

    def add(self, block_id: int, meta: EvictableMeta) -> None:
        self._meta[block_id] = meta

    def remove(self, block_id: int) -> bool:
        return self._meta.pop(block_id, None) is not None

    def evict(self, now: float) -> Optional[int]:
        best, best_w = None, math.inf
        for bid, meta in self._meta.items():          # O(n)
            tau = max(now - meta.last_access, 0.0)
            w = math.log(1.0 / (1.0 + tau / self.tau_scale)) + meta.log_cost
            if w < best_w:
                best, best_w = bid, w
        if best is not None:
            del self._meta[best]
        return best

    def __len__(self) -> int:
        return len(self._meta)

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._meta


POLICIES = {
    "asymcache": AsymCacheEvictor,
    "asymcache-on": AsymCacheLinearEvictor,
    "lru": LRUEvictor,
    "maxscore": MaxScoreEvictor,
    "pensieve": PensieveEvictor,
}


def make_policy(name: str, freq: FreqParams, **kw) -> EvictionPolicy:
    cls = POLICIES[name]
    if cls is LRUEvictor:
        return cls()
    return cls(freq, **kw)


def policy_op_counts(policy: EvictionPolicy) -> Dict[str, int]:
    """Deterministic control-plane op counts of a policy instance.

    AsymCache exposes treap spine steps and add/remove/evict calls;
    other policies (no instrumented structures) report zeros so the
    stress benchmark's counter schema is policy-independent."""
    if isinstance(policy, AsymCacheEvictor):
        return {
            "treap_ops": policy.bt1.n_ops + policy.bt2.n_ops,
            "evictor_adds": policy.n_adds,
            "evictor_removes": policy.n_removes,
            "evictor_evicts": policy.n_evicts,
        }
    return {"treap_ops": 0, "evictor_adds": 0,
            "evictor_removes": 0, "evictor_evicts": 0}
