"""Deterministic fault injection for the serving stack.

A :class:`FaultPlan` is threaded through the server, scheduler and
``BlockManager`` and consulted at a small set of *named sites* — the
places where production KV-cache managers actually fail (host-tier
payload loss, corrupt swap payloads, pool OOM at admission, device
dispatch errors, user-code exceptions from request sources and
streaming callbacks).  Each consultation *arms* the site; whether the
n-th arming *fires* is a pure function of ``(seed, site, nth)``, so a
chaos run is exactly reproducible and a baseline run with the same
workload but no plan is exactly fault-free.

The degradation contract (docs/SERVING.md "Failure semantics"):

* lost / corrupt host payloads fall back to the paper's lossless
  recompute path — outputs stay byte-identical;
* pool OOM at admission defers (backpressure), never kills the loop;
* dispatch failures roll the step back and retry with backoff;
* source / callback exceptions are isolated to the owning request,
  which lands in a terminal ``failed``/``rejected`` state with every
  block, pin and prefetch it owned released.
"""
from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Tuple

#: Every site a FaultPlan may fire at.  Keep in sync with the
#: degradation matrix in docs/SERVING.md.
FAULT_SITES: Tuple[str, ...] = (
    "swap_in_loss",    # host-tier payload lost in transit (transient)
    "host_corrupt",    # host-entry payload corrupted (checksum mismatch)
    "admission_oom",   # pool allocation fails at admission
    "dispatch_fail",   # device step dispatch raises
    "source_error",    # RequestSource.pop_due raises
    "on_token_error",  # streaming on_token callback raises
)


class InjectedFault(RuntimeError):
    """Raised at an armed fault site by the chaos layer.

    Sites that model *exceptions from foreign code* (request sources,
    streaming callbacks, device dispatch) raise this inside the same
    guarded region that protects against genuinely-throwing user code,
    so injection exercises exactly the production handling path.
    """


class FaultPlan:
    """Seeded, counted schedule of injected failures.

    Two trigger mechanisms compose per site:

    * ``at``    — explicit 1-based arming indices that always fire
                  (``{"swap_in_loss": {1, 3}}`` fires the 1st and 3rd
                  time the site is armed);
    * ``rates`` — probability per arming; the draw for the n-th arming
                  is ``random.Random(f"{seed}/{site}/{nth}").random()``,
                  stable across processes and platforms.

    ``limit`` caps total fires per site.  ``should_fire`` is the only
    mutating entry point; ``counts()`` exposes armed/fired tallies in a
    flat dict merged into server results.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 at: Optional[Dict[str, Iterable[int]]] = None,
                 limit: Optional[int] = None):
        unknown = (set(rates or ()) | set(at or ())) - set(FAULT_SITES)
        if unknown:
            raise ValueError(f"unknown fault sites: {sorted(unknown)}; "
                             f"valid sites: {FAULT_SITES}")
        self.seed = seed
        self.rates = dict(rates or {})
        self.at = {site: frozenset(nths) for site, nths in (at or {}).items()}
        self.limit = limit
        self._armed: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        #: chronological (site, nth-arming) log of every fire
        self.log: List[Tuple[str, int]] = []

    @staticmethod
    def draw(seed: int, site: str, nth: int) -> float:
        """The uniform draw deciding the n-th arming of ``site`` —
        a pure function of its arguments (string seeding hashes via
        SHA-512, so it is stable across processes)."""
        return random.Random(f"{seed}/{site}/{nth}").random()

    def should_fire(self, site: str) -> bool:
        """Arm ``site`` once; return True iff this arming fires."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site: {site!r}")
        nth = self._armed.get(site, 0) + 1
        self._armed[site] = nth
        if self.limit is not None and self._fired.get(site, 0) >= self.limit:
            return False
        fire = nth in self.at.get(site, ())
        if not fire:
            rate = self.rates.get(site, 0.0)
            if rate > 0.0:
                fire = self.draw(self.seed, site, nth) < rate
        if fire:
            self._fired[site] = self._fired.get(site, 0) + 1
            self.log.append((site, nth))
        return fire

    def armed(self, site: str) -> int:
        return self._armed.get(site, 0)

    def fired(self, site: str) -> int:
        return self._fired.get(site, 0)

    def total_fired(self) -> int:
        return sum(self._fired.values())

    def sites_fired(self) -> List[str]:
        """Distinct sites that have fired, sorted."""
        return sorted(self._fired)

    def counts(self) -> Dict[str, int]:
        """Flat armed/fired tallies (merged into server results)."""
        out: Dict[str, int] = {}
        for site in FAULT_SITES:
            out[f"faults_armed_{site}"] = self._armed.get(site, 0)
            out[f"faults_fired_{site}"] = self._fired.get(site, 0)
        out["faults_fired_total"] = self.total_fired()
        return out
