"""Content-addressed global prefix store (cross-restart, multi-tenant).

The block manager's chain-hash table is position- *and* process-bound:
``hash_seed(salt)`` chains die with the interpreter, so two servers (or
one server across a restart) can never recognize that they computed the
same prompt block.  This module promotes the host tier into a **global
prefix store** keyed by *content*:

* **Content keys** — truncated SHA-256 chained over ``(model
  fingerprint, previous key, token block)``.  Identical prompt blocks
  map to identical keys in every process, regardless of arrival order,
  so popular system prompts dedupe across requests, sessions, and
  restarts.  The model fingerprint folds the architecture config and a
  weights version into the chain: change the weights and every stored
  key is unreachable (stale KV can never resolve).
* **Restart survival** — host-tier payloads (including the per-half
  quantized wire formats of the offload path) pickle to disk via the
  ``offload.py`` wire helpers and restore on boot.  Entry ages are
  normalized at save time so TTL expiry keeps working across the
  restart gap without wall clocks.
* **Per-tenant quotas** — every entry records its owning tenants; a
  tenant over its byte quota sheds only *its own* coldest entries
  (LFU-primary, LRU-tiebreak), so tenants sharing a popular system
  prompt cannot evict each other's private tails.  An over-quota
  deposit is rejected (the block is simply recomputed next time) —
  never satisfied by evicting a neighbor.
* **Admission pre-flight** — :meth:`PrefixStore.analyze_batch` dedupes
  the content keys of an arriving batch so the scheduler can hold
  duplicate-prefix followers until their leader's shared blocks commit
  (one prefill instead of N concurrent identical ones).

The §4 lossless contract is preserved end to end: a store miss, a
checksum mismatch, a fingerprint mismatch, or a rejected deposit all
degrade to recompute — never to wrong bytes.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .offload import (
    HostEntry,
    HostHalf,
    entry_from_wire,
    entry_to_wire,
    half_checksum,
    verify_half,
)

STORE_SNAPSHOT_VERSION = 1


# ---------------------------------------------------------------------------
# content keys
# ---------------------------------------------------------------------------

def model_fingerprint(cfg, weights_version: str = "v0") -> bytes:
    """16-byte fingerprint of the model identity: the (frozen dataclass)
    architecture config plus an opaque weights-version tag.  Stored KV is
    only resolvable under the exact fingerprint it was computed with."""
    h = hashlib.sha256()
    try:
        import dataclasses
        items = sorted(dataclasses.asdict(cfg).items())
    except TypeError:
        items = sorted(vars(cfg).items())
    h.update(repr(items).encode())
    h.update(b"\x00")
    h.update(weights_version.encode())
    return h.digest()[:16]


def content_key(fingerprint: bytes, prev: bytes, tokens: Sequence[int],
                key_bytes: int = 16) -> bytes:
    """Truncated-SHA content key of one block, chained on ``prev`` so a
    block's key commits to its whole prefix (position-free, order-free)."""
    h = hashlib.sha256()
    h.update(fingerprint)
    h.update(prev)
    h.update(np.asarray(tokens, dtype=np.uint32).tobytes())
    return h.digest()[:key_bytes]


def content_key_chain(fingerprint: bytes, tokens: Sequence[int],
                      block_size: int, key_bytes: int = 16) -> List[bytes]:
    """Content keys for each *full* block of ``tokens`` (the content
    analogue of ``BlockManager.block_hashes``)."""
    out: List[bytes] = []
    prev = b""
    n_full = len(tokens) // block_size
    for i in range(n_full):
        prev = content_key(fingerprint, prev,
                           tokens[i * block_size:(i + 1) * block_size],
                           key_bytes)
        out.append(prev)
    return out


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PrefixStoreConfig:
    """Knobs for the content-addressed store.  ``capacity_bytes == 0``
    (the default) disables the store entirely — the server still
    constructs one so its counters merge as zeros into every result."""
    capacity_bytes: int = 0          # 0 = store disabled
    tenant_quota_bytes: int = 0      # 0 = no per-tenant quota
    ttl: float = 0.0                 # model-time seconds; 0 = no expiry
    key_bytes: int = 16              # truncated-SHA key width
    weights_version: str = "v0"      # folds into the model fingerprint
    snapshot_path: Optional[str] = None   # restore from here at boot
    max_tracked: int = 16384         # payload-less interest entries kept


@dataclass
class StoreEntry:
    """One content-addressed block.  ``payload is None`` marks tracked
    interest (owners registered at match time, bytes not yet deposited)."""
    block_pos: int
    payload: Optional[HostEntry] = None
    owners: Set[str] = field(default_factory=set)
    hits: int = 0
    last_tick: int = 0               # logical recency (LRU tiebreak)
    born: float = 0.0                # store clock at deposit (TTL base)
    pins: int = 0                    # outstanding acquire() leases


@dataclass
class BatchReport:
    """Pre-flight dedup report for one admission batch."""
    n_requests: int
    total_blocks: int
    unique_blocks: int
    dup_blocks: int
    payload_hits: int                # unique keys already holding bytes
    followers: List[Tuple[int, int]]  # (follower_idx, leader_idx) pairs


def _clone_half(h: Optional[HostHalf]) -> Optional[HostHalf]:
    if h is None:
        return None
    return HostHalf(data=h.data, scale=h.scale, nbytes=h.nbytes,
                    fmt=h.fmt, checksum=h.checksum)


def clone_entry(e: HostEntry) -> HostEntry:
    """Fresh ``HostEntry``/``HostHalf`` containers sharing the payload
    arrays.  The block manager mutates host-tier entries in place
    (half drops, corruption injection), so the store never shares its
    master containers with the tier — only the immutable arrays."""
    return HostEntry(block_pos=e.block_pos,
                     k=_clone_half(e.k), v=_clone_half(e.v))


def _seal(e: HostEntry) -> None:
    for hh in (e.k, e.v):
        if hh is not None and hh.checksum is None:
            hh.checksum = half_checksum(hh)


class PrefixStore:
    """Content-addressed, multi-tenant, restart-surviving prefix store.

    Eviction is an LFU/LRU hybrid: victims are chosen by minimum
    ``(hits, last_tick)`` — frequency first (a popular system prompt
    outlives any burst of one-off tails), logical recency as tiebreak.
    All clocks are model-time / logical ticks: nothing here reads a
    wall clock, so every decision replays deterministically."""

    def __init__(self, cfg: Optional[PrefixStoreConfig] = None,
                 fingerprint: bytes = b""):
        self.cfg = cfg or PrefixStoreConfig()
        self.fingerprint = fingerprint
        self._entries: Dict[bytes, StoreEntry] = {}
        self._charged: Dict[str, int] = {}   # tenant -> owned bytes
        self._bytes = 0                      # total payload bytes
        self._tick = 0
        # counters (schema frozen in tests/test_perf_counters.py)
        self.n_puts = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_evictions = 0
        self.n_expired = 0
        self.n_restored = 0
        self.n_corrupt_drops = 0
        self.n_fingerprint_drops = 0
        self.n_quota_rejects = 0
        self.n_preflight_reports = 0
        self.n_preflight_dup_blocks = 0
        self.n_preflight_holds = 0
        self.n_tenant_evictions = 0
        self.n_shed_ownerships = 0

    # ------------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.cfg.capacity_bytes > 0

    def keys_for(self, tokens: Sequence[int],
                 block_size: int) -> List[bytes]:
        return content_key_chain(self.fingerprint, tokens, block_size,
                                 self.cfg.key_bytes)

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    @staticmethod
    def _entry_bytes(e: StoreEntry) -> int:
        return e.payload.nbytes if e.payload is not None else 0

    # ------------------------------------------------------------------
    # interest registration (match-time) + pre-flight dedup
    # ------------------------------------------------------------------
    def register(self, ck: bytes, tenant: str, block_pos: int) -> None:
        """Record that ``tenant`` uses the content behind ``ck`` so a
        later deposit (eviction-time spill) attributes ownership to the
        tenants that actually share the prefix.  Payload-less entries
        are bounded by ``max_tracked`` (oldest interest pruned)."""
        if not self.enabled:
            return
        e = self._entries.get(ck)
        if e is None:
            e = StoreEntry(block_pos=block_pos, born=0.0)
            self._entries[ck] = e
            self._prune_tracked()
        if e.payload is not None:
            # renewed interest in stored content: ownership is charged
            # (and the tenant's own quota enforced) like any access
            self._add_owner(e, ck, tenant)
        else:
            e.owners.add(tenant)
        e.last_tick = self._next_tick()

    def _prune_tracked(self) -> None:
        tracked = [ck for ck, e in self._entries.items()
                   if e.payload is None]
        if len(tracked) <= self.cfg.max_tracked:
            return
        for ck in tracked[:len(tracked) - self.cfg.max_tracked // 2]:
            del self._entries[ck]

    def owner_hint(self, ck: bytes) -> str:
        """Deterministic deposit attribution: the first registered owner
        of the content, or "default" when no interest was recorded."""
        e = self._entries.get(ck)
        if e is not None and e.owners:
            return min(e.owners)
        return "default"

    def analyze_batch(
            self, batch: Sequence[Tuple[str, Sequence[bytes]]]
    ) -> BatchReport:
        """Dedup the content keys of one admission batch.  A request
        whose *leading* key repeats an earlier batch member's leading
        key is a follower: the scheduler may hold it until the leader's
        shared blocks commit, turning N concurrent identical prefills
        into one prefill plus N-1 table hits."""
        seen: Dict[bytes, int] = {}
        total = dup = payload_hits = 0
        uniq: Set[bytes] = set()
        followers: List[Tuple[int, int]] = []
        for idx, (_tenant, keys) in enumerate(batch):
            for ck in keys:
                total += 1
                if ck in uniq:
                    dup += 1
                else:
                    uniq.add(ck)
                    e = self._entries.get(ck)
                    if e is not None and e.payload is not None:
                        payload_hits += 1
            if keys:
                leader = seen.get(keys[0])
                if leader is None:
                    seen[keys[0]] = idx
                else:
                    followers.append((idx, leader))
        self.n_preflight_reports += 1
        self.n_preflight_dup_blocks += dup
        self.n_preflight_holds += len(followers)
        return BatchReport(n_requests=len(batch), total_blocks=total,
                           unique_blocks=len(uniq), dup_blocks=dup,
                           payload_hits=payload_hits, followers=followers)

    # ------------------------------------------------------------------
    # deposit / acquire / release
    # ------------------------------------------------------------------
    def deposit(self, ck: bytes, entry: HostEntry, tenant: str,
                now: float, block_pos: int = 0) -> bool:
        """Store one complete block payload under its content key.
        Returns False (caller recomputes later — lossless) when the
        store is disabled, the payload is incomplete, or any quota
        would require evicting a *different* tenant's entries."""
        if not self.enabled or entry is None or not entry.complete:
            return False
        prev = self._entries.get(ck)
        if prev is not None and prev.payload is not None:
            # identical content already stored: refresh recency/owners
            prev.hits += 1
            prev.last_tick = self._next_tick()
            self._add_owner(prev, ck, tenant)
            return True
        nb = entry.nbytes
        quota = self.cfg.tenant_quota_bytes
        if nb > self.cfg.capacity_bytes or (quota > 0 and nb > quota):
            self.n_quota_rejects += 1
            return False
        stored = clone_entry(entry)
        _seal(stored)
        owners = set(prev.owners) if prev is not None else set()
        owners.add(tenant)
        e = StoreEntry(block_pos=entry.block_pos if block_pos == 0
                       else block_pos,
                       payload=stored, owners=owners,
                       hits=1, last_tick=self._next_tick(), born=now)
        self._entries[ck] = e
        self._bytes += nb
        for t in owners:
            self._charged[t] = self._charged.get(t, 0) + nb
        self.n_puts += 1
        for t in list(owners):
            self._enforce_tenant_quota(t)
        self._enforce_capacity()
        return ck in self._entries and self._entries[ck].payload is not None

    def acquire(self, ck: bytes, tenant: str,
                now: float) -> Optional[HostEntry]:
        """Fetch the payload behind ``ck`` for ``tenant``.  Returns a
        fresh container (safe for the host tier to mutate/consume) and
        pins the entry until :meth:`release` — the lease the analysis
        lease pass tracks.  None = miss (expired, evicted, never
        deposited): the caller degrades to recompute."""
        if not self.enabled:
            return None
        e = self._entries.get(ck)
        if e is not None and e.payload is not None and self._expired(e, now):
            self._remove(ck, counted_as="expired")
            e = None
        if e is None or e.payload is None:
            self.n_misses += 1
            return None
        e.hits += 1
        e.last_tick = self._next_tick()
        self.n_hits += 1
        self._add_owner(e, ck, tenant)
        e.pins += 1
        return clone_entry(e.payload)

    def release(self, ck: bytes) -> None:
        """Drop the acquire() pin.  Safe on entries that vanished in
        between (a corrupt fetch drops the entry before releasing)."""
        e = self._entries.get(ck)
        if e is not None and e.pins > 0:
            e.pins -= 1

    def drop_corrupt(self, ck: bytes) -> None:
        """A fetched payload failed checksum verification: purge it so
        the corruption cannot be served twice (§4 — recompute, never
        wrong bytes)."""
        if ck in self._entries:
            self._remove(ck, counted_as="corrupt")

    def _add_owner(self, e: StoreEntry, ck: bytes, tenant: str) -> None:
        """Best-effort ownership on access: the tenant is charged for
        the entry (and its own quota enforced).  If the entry alone
        exceeds the tenant's quota, ownership is refused — the hit is
        still served (reading a shared prefix is free; only *retention*
        is quota-bound)."""
        if tenant in e.owners:
            return
        nb = self._entry_bytes(e)
        quota = self.cfg.tenant_quota_bytes
        if quota > 0 and nb > quota:
            return
        e.owners.add(tenant)
        if nb:
            self._charged[tenant] = self._charged.get(tenant, 0) + nb
            self._enforce_tenant_quota(tenant)

    # ------------------------------------------------------------------
    # capacity / quota / TTL enforcement
    # ------------------------------------------------------------------
    def _expired(self, e: StoreEntry, now: float) -> bool:
        return self.cfg.ttl > 0 and (now - e.born) > self.cfg.ttl

    def expire(self, now: float) -> int:
        """Drop every payload entry older than the TTL.  Called at
        snapshot time and usable from maintenance loops."""
        if self.cfg.ttl <= 0:
            return 0
        dead = [ck for ck, e in self._entries.items()
                if e.payload is not None and self._expired(e, now)]
        for ck in dead:
            self._remove(ck, counted_as="expired")
        return len(dead)

    def _remove(self, ck: bytes, counted_as: str) -> None:
        e = self._entries.pop(ck)
        nb = self._entry_bytes(e)
        if nb:
            self._bytes -= nb
            for t in e.owners:
                left = self._charged.get(t, 0) - nb
                if left > 0:
                    self._charged[t] = left
                else:
                    self._charged.pop(t, None)
        if counted_as == "expired":
            self.n_expired += 1
        elif counted_as == "corrupt":
            self.n_corrupt_drops += 1
        elif counted_as == "evicted":
            self.n_evictions += 1
        elif counted_as == "tenant":
            self.n_tenant_evictions += 1

    def _victims_for(self, tenant: Optional[str]):
        """Unpinned payload entries (optionally owned by ``tenant``),
        coldest first: minimum (hits, last_tick) — LFU with LRU
        tiebreak."""
        cand = [(e.hits, e.last_tick, ck) for ck, e in self._entries.items()
                if e.payload is not None and e.pins == 0
                and (tenant is None or tenant in e.owners)]
        cand.sort()
        return [ck for _h, _t, ck in cand]

    def _enforce_tenant_quota(self, tenant: str) -> None:
        """Shed the over-quota tenant's own coldest entries.  A shared
        entry only loses this tenant's *ownership* (the bytes stay for
        the co-owners); a sole-owned entry is evicted.  Neighbors are
        never touched — that is the isolation invariant."""
        quota = self.cfg.tenant_quota_bytes
        if quota <= 0:
            return
        for ck in self._victims_for(tenant):
            if self._charged.get(tenant, 0) <= quota:
                return
            e = self._entries[ck]
            nb = self._entry_bytes(e)
            if len(e.owners) > 1:
                e.owners.discard(tenant)
                left = self._charged.get(tenant, 0) - nb
                if left > 0:
                    self._charged[tenant] = left
                else:
                    self._charged.pop(tenant, None)
                self.n_shed_ownerships += 1
            else:
                self._remove(ck, counted_as="tenant")

    def _enforce_capacity(self) -> None:
        for ck in self._victims_for(None):
            if self._bytes <= self.cfg.capacity_bytes:
                return
            self._remove(ck, counted_as="evicted")

    # ------------------------------------------------------------------
    # restart survival
    # ------------------------------------------------------------------
    def save(self, path: str, now: float) -> int:
        """Persist every payload entry.  Ages are stored relative to
        ``now`` so TTL expiry survives the restart gap without a wall
        clock; the fingerprint guards against weight changes."""
        self.expire(now)
        recs = []
        for ck, e in self._entries.items():
            if e.payload is None:
                continue
            recs.append({
                "ck": ck,
                "block_pos": e.block_pos,
                "age": max(now - e.born, 0.0),
                "hits": e.hits,
                "owners": sorted(e.owners),
                "entry": entry_to_wire(e.payload),
            })
        blob = {
            "version": STORE_SNAPSHOT_VERSION,
            "fingerprint": self.fingerprint,
            "key_bytes": self.cfg.key_bytes,
            "entries": recs,
        }
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
        os.replace(tmp, path)
        return len(recs)

    def load(self, path: str, now: float) -> int:
        """Restore a snapshot.  Every failure mode is lossless: an
        unreadable file restores nothing, a fingerprint mismatch drops
        everything (stale weights), an over-TTL or checksum-failing
        entry is skipped.  Returns the number of entries restored."""
        if not self.enabled or not os.path.exists(path):
            return 0
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            assert blob["version"] == STORE_SNAPSHOT_VERSION
            recs = blob["entries"]
        except Exception:
            self.n_corrupt_drops += 1
            return 0
        if blob.get("fingerprint") != self.fingerprint \
                or blob.get("key_bytes") != self.cfg.key_bytes:
            self.n_fingerprint_drops += len(recs)
            return 0
        restored = 0
        for rec in recs:
            try:
                age = float(rec["age"])
                if self.cfg.ttl > 0 and age > self.cfg.ttl:
                    self.n_expired += 1
                    continue
                entry = entry_from_wire(rec["entry"])
                if not entry.complete or not (
                        verify_half(entry.k) and verify_half(entry.v)):
                    self.n_corrupt_drops += 1
                    continue
                owners = set(rec["owners"]) or {"default"}
                tenant = next(iter(owners))
                if not self.deposit(rec["ck"], entry, tenant,
                                    now=now - age,
                                    block_pos=int(rec["block_pos"])):
                    continue
                e = self._entries.get(rec["ck"])
                if e is not None and e.payload is not None:
                    e.hits = max(int(rec["hits"]), 1)
                    for t in owners:
                        self._add_owner(e, rec["ck"], t)
                    restored += 1
            except Exception:
                self.n_corrupt_drops += 1
        self.n_restored += restored
        return restored

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        """Deterministic store/tenancy accounting, merged verbatim into
        every server result (frozen in tests/test_perf_counters.py)."""
        return {
            "store_entries": sum(
                1 for e in self._entries.values() if e.payload is not None),
            "store_bytes": self._bytes,
            "store_puts": self.n_puts,
            "store_hits": self.n_hits,
            "store_misses": self.n_misses,
            "store_evictions": self.n_evictions,
            "store_expired": self.n_expired,
            "store_restored": self.n_restored,
            "store_corrupt_drops": self.n_corrupt_drops,
            "store_fingerprint_drops": self.n_fingerprint_drops,
            "store_quota_rejects": self.n_quota_rejects,
            "store_preflight_reports": self.n_preflight_reports,
            "store_preflight_dup_blocks": self.n_preflight_dup_blocks,
            "store_preflight_holds": self.n_preflight_holds,
            "tenant_count": len(self._charged),
            "tenant_quota_evictions": self.n_tenant_evictions,
            "tenant_shed_ownerships": self.n_shed_ownerships,
        }

    def check_invariants(self) -> None:
        """Audit the tenancy/byte accounting (called from
        ``BlockManager.check_invariants``): total bytes match the
        entries; per-tenant charges match the ownership sets; no tenant
        exceeds its quota beyond pinned (in-flight acquire) bytes; every
        payload entry has at least one owner; pins are non-negative."""
        total = 0
        charged: Dict[str, int] = {}
        for ck, e in self._entries.items():
            assert e.pins >= 0, (ck, e.pins)
            nb = self._entry_bytes(e)
            if e.payload is not None:
                assert e.owners, f"unowned payload entry {ck!r}"
                assert e.payload.complete, f"incomplete payload {ck!r}"
            total += nb
            for t in e.owners:
                charged[t] = charged.get(t, 0) + nb
        assert total == self._bytes, (total, self._bytes)
        charged = {t: b for t, b in charged.items() if b > 0}
        assert charged == self._charged, (charged, self._charged)
        quota = self.cfg.tenant_quota_bytes
        if quota > 0:
            for t, b in charged.items():
                pinned = sum(
                    self._entry_bytes(e) for e in self._entries.values()
                    if e.pins > 0 and t in e.owners)
                assert b <= quota + pinned, \
                    f"tenant {t} over quota: {b} > {quota} (+{pinned} pinned)"
        if self.enabled:
            pinned = sum(self._entry_bytes(e)
                         for e in self._entries.values() if e.pins > 0)
            assert self._bytes <= self.cfg.capacity_bytes + pinned, \
                (self._bytes, self.cfg.capacity_bytes, pinned)
