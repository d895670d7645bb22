"""Paged KV-cache block manager with multi-segment (non-prefix) matching.

The pool holds ``num_blocks`` fixed-size blocks.  A cached block is keyed by
the **chain hash** of all tokens from the start of the sequence through the
end of that block — the lossless-reuse condition (a block's K/V depend on
its entire prefix).  Because the evictor can evict arbitrary blocks, a new
request may hit any *subset* of its blocks, producing multiple discontiguous
hit segments; the gaps are recomputed via Multi-Segment Attention.

Bookkeeping per block:
  * ``block_pos``   — immutable positional index within its sequence (number
                      of predecessor blocks) → the Eq.-7 cost term.
  * ``ref_count``   — active requests currently mapping the block.
  * ``pinned_until``— Continuum-style TTL pin (ignored by eviction).
  * frequency state — last access + EWMA count (feeds the evictor keys).

Cross-request prefix sharing (radix trie + copy-on-write):
  * Any committed block is *already* shareable across requests through the
    chain-hash table — a second request whose tokens reproduce the chain
    simply acquires the same slot (``ref_count`` > 1) and the evictor
    cannot touch it because referenced blocks are never in the evictable
    set.  That invariant is what makes sharing safe: refcount>1 ⇒
    unevictable, structurally.
  * The :class:`~repro_torch.core.prefix_trie.PrefixTrie` extends sharing to the
    *partial* block at a divergence point: ``fork_into`` schedules a
    device page copy from the donor block (copy-on-write — the fork
    happens exactly when a writer diverges) and the requester recomputes
    only from the divergence token onward.
  * ``hash_salt`` isolates a request from the shared namespace (the
    no-sharing baseline: every request recomputes its whole prompt).
  * ``peak_ref`` (max concurrent sharers while resident) is folded into
    the eviction objective: a block that served k concurrent requests has
    its recompute cost weighted k× — evicting it forfeits k requests'
    worth of savings.
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.evictor import EvictableMeta, EvictionPolicy
from repro_torch.core.faults import FaultPlan
from repro_torch.core.freq import EwmaCounter, FreqParams
from repro_torch.core.offload import (HostEntry, HostHalf, OffloadConfig,
                                ScaleCache, half_checksum, quantize_half,
                                verify_half)
from repro_torch.core.prefix_store import PrefixStore
from repro_torch.core.prefix_trie import PrefixTrie


def chain_hash(prev_hash: int, tokens: Tuple[int, ...]) -> int:
    return hash((prev_hash, tokens))


def hash_seed(salt: int) -> int:
    """Chain-hash seed: salt 0 is the shared namespace; any other salt
    isolates the request's blocks from cross-request reuse."""
    return 0 if salt == 0 else hash(("prefix-salt", salt))


@dataclass
class Block:
    slot: int                       # index into the device KV pool
    key: Optional[int] = None       # chain hash (None = uncommitted)
    block_pos: int = 0
    ref_count: int = 0
    peak_ref: int = 1               # max concurrent sharers while resident
    pinned_until: float = -math.inf
    last_access: float = 0.0
    count: float = 1.0              # EWMA hit count
    boost: float = 1.0              # agentic tool-call correction factor
    # k-early prefetch restored only the K half; the V half is still
    # host-resident (pinned) and streams in when the block is acquired
    v_pending: bool = False


@dataclass
class MatchResult:
    """Per-request match: block-level hits and the segment structure."""
    hit_slots: List[Optional[int]]  # per block idx: pool slot or None
    num_blocks: int
    hit_mask: List[bool]
    # blocks resident in the HOST tier (paper §7 hierarchical storage):
    # reusable via swap-in instead of recompute
    host_hits: List[bool] = field(default_factory=list)

    @property
    def num_hits(self) -> int:
        return sum(self.hit_mask)

    def segments(self) -> List[Tuple[int, int, bool]]:
        """[(start_block, end_block, is_hit)] alternating runs."""
        segs: List[Tuple[int, int, bool]] = []
        i = 0
        while i < self.num_blocks:
            j = i
            while j < self.num_blocks and self.hit_mask[j] == self.hit_mask[i]:
                j += 1
            segs.append((i, j, self.hit_mask[i]))
            i = j
        return segs


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int,
                 policy: EvictionPolicy, cost_model: CostModel,
                 freq: FreqParams, count_gamma: Optional[float] = None,
                 host_blocks: int = 0,
                 swap_out_fn=None, swap_in_fn=None,
                 prefix_sharing: bool = True,
                 n_shards: int = 1,
                 offload: Optional[OffloadConfig] = None,
                 block_bytes: Optional[Tuple[int, int]] = None,
                 payload_half_bytes: Optional[Tuple[int, int]] = None,
                 pcie_bw: float = 1.2e10,
                 faults: Optional[FaultPlan] = None,
                 store: Optional[PrefixStore] = None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        # ---- KV sharding (sharded serving engine): the device page pool
        # is split into n contiguous runs of num_blocks/n pages, one per
        # device.  Slot -> shard is a pure function (slot // shard_size,
        # matching how GSPMD shards the pool's page axis); the manager's
        # job is to keep allocation striped so every sequence's context
        # spreads across shards (that is what makes each shard's pages a
        # "segment subset" the flash-decode LSE merge can combine).
        assert n_shards >= 1 and num_blocks % n_shards == 0, \
            (num_blocks, n_shards)
        self.n_shards = n_shards
        self.shard_size = num_blocks // n_shards
        self.policy = policy
        self.cost_model = cost_model
        self.freq = freq
        self.count_gamma = count_gamma or freq.lifespan
        self.blocks: List[Block] = [Block(slot=i) for i in range(num_blocks)]
        self.free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.table: Dict[int, int] = {}     # chain hash -> slot
        # ---- host tier (paper §7, split K/V residency): evicted blocks
        # spill to host memory as per-half payloads (Kcache asymmetry:
        # the K and V halves place independently).  Reload cost is
        # SIZE-based (one PCIe/DMA copy), not position-based, so the
        # device evictor's position-aware policy is unchanged; the host
        # tier runs LRU over (key -> HostEntry) under a BYTE budget of
        # host_blocks full-precision blocks — quantized payloads
        # therefore fit proportionally more blocks in the same budget.
        self.host_blocks = host_blocks
        self.host_tier: "OrderedDict[int, HostEntry]" = OrderedDict()
        # ---- content-addressed global prefix store (core/prefix_store):
        # chain hash -> content key for blocks this process has resolved,
        # so eviction-time spills can deposit under restart-stable keys.
        # The map is bounded (LRU) — it is a cache of resolutions, not an
        # accounting structure.
        self.store = store
        self._content_of: "OrderedDict[int, bytes]" = OrderedDict()
        self._content_cap = max(4 * num_blocks, 1024)
        # slot -> (k_half|None, v_half|None); None = read from pool.
        # ALSO purges any still-queued swap-in halves for the slot.
        self.swap_out_fn = swap_out_fn
        self.swap_in_fn = swap_in_fn        # (slot, (k|None, v|None)) -> None
        self.offload = offload or OffloadConfig()
        # full-precision per-half bytes (budget unit) and the configured
        # wire-format per-half bytes (sim accounting when payloads are
        # never materialized); (1, 1) keeps unit-test BlockManagers on
        # "1 byte per half" so the byte budget degenerates to the old
        # host_blocks entry count exactly
        self._fp_half_bytes = tuple(block_bytes) if block_bytes else (1, 1)
        self._wire_half_bytes = (tuple(payload_half_bytes)
                                 if payload_half_bytes
                                 else self._fp_half_bytes)
        self._host_budget = host_blocks * sum(self._fp_half_bytes)
        self._grid_scale = self.offload.clip / 127.0
        self._scales = ScaleCache(
            self.offload.scale_cache if self.offload.lossy_offload else 0)
        # chain hash -> device slot of blocks whose host V half must not
        # be dropped (a k-early restore owes its V completion to it)
        self._host_pinned: Dict[int, int] = {}
        self.pcie_bw = pcie_bw
        self.n_swap_ins = 0
        self.n_swap_outs = 0
        self.host_resident_bytes = 0
        self.bytes_swapped_in_k = 0
        self.bytes_swapped_in_v = 0
        self.bytes_swapped_out_k = 0
        self.bytes_swapped_out_v = 0
        self.n_host_evictions = 0       # whole entries LRU-dropped
        self.n_host_half_drops = 0      # single halves shed (entry kept)
        self.n_clean_half_spills = 0    # spilled halves the host already had
        self.n_v_half_streams = 0       # k-early V halves streamed on demand
        self.n_k_early_prefetches = 0
        self.n_pending_purges = 0       # v_pending blocks orphaned -> miss
        # ---- cross-request prefix sharing: token radix trie over served
        # sequences + pending copy-on-write page copies (engine-drained)
        self.prefix_trie: Optional[PrefixTrie] = \
            PrefixTrie() if prefix_sharing else None
        self.pending_copies: List[Tuple[int, int]] = []   # (src, dst) slots
        self.n_cow_forks = 0
        self.n_prefix_matches = 0
        self.prefix_tokens_matched = 0
        # ---- predictive host-tier prefetch (online session serving): the
        # frontend calls prefetch() ahead of a session's predicted resume;
        # restored blocks are TTL-pinned until the resume and tracked in
        # prefetch_slots (slot -> owning session, None = unowned) so
        # _acquire can count realized prefetch hits — and so only the
        # OWNING session's resume drops the pin (a foreign session hitting
        # a shared-prefix block must not strip protection the owner's
        # still-pending resume relies on).
        self.prefetch_slots: Dict[int, Optional[int]] = {}
        self.n_prefetch_issued = 0      # blocks the frontend asked for
        self.n_prefetch_pins = 0        # already device-resident -> pinned
        self.n_prefetch_swap_ins = 0    # restored host -> device early
        self.n_prefetch_hits = 0        # prefetched blocks later acquired
        self.n_prefetch_misses = 0      # neither on device nor in host tier
        self.n_prefetch_alloc_fail = 0  # no device slot free to restore into
        # ---- TTL pin expiry: a lazy min-heap of (until, slot) entries.
        # Every positive pin goes through pin(), which pushes its current
        # pinned_until; direct unpins (realize/cancel_prefetch) just set
        # pinned_until and leave a stale entry behind — an entry is live
        # iff it still equals the block's pinned_until.  unpin_expired /
        # earliest_pin_expiry pop expired+stale entries in O(log n) each
        # instead of scanning all num_blocks blocks per step (the 5k-
        # session control-plane stress gate caught the O(num_blocks) scan).
        self._pin_heap: List[Tuple[float, int]] = []
        self.n_pin_heap_ops = 0
        # evictable-set re-ranks forced by set_boost (§5.2 suspend boost)
        self.n_evictor_reranks = 0
        # ---- fault injection + graceful degradation (core/faults.py):
        # lost or corrupt host payloads degrade to the §4 lossless
        # recompute path; payload checksums are computed at spill and
        # verified at acquire whenever a plan is attached (or forced via
        # offload.verify_payloads); every injected fault is followed by a
        # full invariant audit.
        self.faults = faults
        self._checksums = faults is not None or self.offload.verify_payloads
        self.swap_retry_limit = 3       # bounded retry on transient loss
        self.n_swap_in_losses = 0       # payload lost beyond all retries
        self.n_swap_in_retries = 0      # transient losses retried away
        self.n_host_corruptions = 0     # checksum mismatches at acquire
        self.n_invariant_audits = 0
        # stats
        self.n_lookups = 0
        self.n_hits = 0
        self.n_evictions = 0
        self.evicted_positions: List[int] = []
        self.hit_positions: List[Tuple[int, int]] = []  # (block_pos, n_blocks)
        self.reuse_intervals: List[float] = []  # observed block reuse gaps

    # ------------------------------------------------------------------
    # matching
    # ------------------------------------------------------------------
    def block_hashes(self, tokens: Sequence[int],
                     salt: int = 0) -> List[int]:
        """Chain hashes for each *full* block of ``tokens``."""
        out = []
        h = hash_seed(salt)
        n_full = len(tokens) // self.block_size
        for i in range(n_full):
            chunk = tuple(tokens[i * self.block_size:(i + 1) * self.block_size])
            h = chain_hash(h, chunk)
            out.append(h)
        return out

    def match(self, tokens: Sequence[int], now: float,
              acquire: bool = True,
              hashes: Optional[List[int]] = None,
              content_keys: Optional[List[bytes]] = None,
              tenant: str = "default") -> MatchResult:
        """Find resident blocks for this token sequence (any subset!).

        With ``acquire=True`` hit blocks are ref-counted and removed from
        the evictable set, so a concurrent eviction can't take them.
        ``hashes`` may be precomputed (admission retries reuse them).

        ``content_keys`` (parallel to ``hashes``) binds each block's
        chain hash to its restart-stable content key: the resolution is
        cached for eviction-time store deposits, tenant interest is
        registered, and a table+host miss falls through to the global
        prefix store — a store hit stages the payload into the host
        tier under the *current* chain hash, so the ordinary swap-in
        path restores it (chain-hash↔content-key equivalence)."""
        if hashes is None:
            hashes = self.block_hashes(tokens)
        if content_keys is not None and self.store is not None \
                and self.store.enabled:
            for pos, (h, ck) in enumerate(zip(hashes, content_keys)):
                self._note_content(h, ck, tenant, pos)
        else:
            content_keys = None
        hit_slots: List[Optional[int]] = []
        hit_mask: List[bool] = []
        host_hits: List[bool] = []
        for pos, h in enumerate(hashes):
            slot = self.table.get(h)
            self.n_lookups += 1
            if slot is not None and self.blocks[slot].v_pending \
                    and not self._host_has(h, "v"):
                # the block's K half is device-resident but its pending V
                # half vanished from the host tier: the content can never
                # be completed, so degrade to a lossless recompute miss
                self._purge_pending_block(h, slot)
                slot = None
            if slot is None:
                hit_slots.append(None)
                hit_mask.append(False)
                # only a COMPLETE host entry can serve a swap-in; a kept-K
                # remnant still needs the block recomputed
                hh = self._host_complete(h)
                if not hh and content_keys is not None:
                    hh = self._store_fetch(content_keys[pos], h, tenant, now)
                host_hits.append(hh)
                continue
            host_hits.append(False)
            self.n_hits += 1
            if acquire:
                self._acquire(slot, now)
            hit_slots.append(slot)
            hit_mask.append(True)
            self.hit_positions.append((pos, len(hashes)))
        return MatchResult(hit_slots=hit_slots, num_blocks=len(hashes),
                           hit_mask=hit_mask, host_hits=host_hits)

    def _acquire(self, slot: int, now: float) -> None:
        """Take a reference on a resident block: un-enqueue it from the
        evictable set and update its frequency/sharing bookkeeping.

        Prefetch state is deliberately untouched here: ``match`` runs
        BEFORE admission is known to succeed, and a failed admission's
        rollback (release) must leave the resume pins standing — the
        scheduler calls :meth:`realize_prefetch` only once the request is
        actually admitted."""
        blk = self.blocks[slot]
        if blk.v_pending:
            # k-early prefetch: the V half streams in exactly when the
            # block is first used — through the in-step swap queue, so it
            # lands before any attention that reads it.  This is a device
            # hit, NOT an admission swap (no resume swap stall).
            self._complete_v_half(slot, blk)
        if blk.ref_count == 0:
            self.policy.remove(slot)
            self.reuse_intervals.append(max(now - blk.last_access, 1e-9))
        blk.ref_count += 1
        blk.peak_ref = max(blk.peak_ref, blk.ref_count)
        blk.count = (blk.count * math.exp(
            -(now - blk.last_access) / self.count_gamma) + 1.0)
        blk.last_access = now

    # ------------------------------------------------------------------
    # cross-request prefix sharing (radix trie + copy-on-write)
    # ------------------------------------------------------------------
    def request_salt(self, rid: int, salt: int = 0) -> int:
        """Effective chain-hash salt for a request.  With prefix sharing
        off, every request gets a private nonzero salt (rid+1) so nothing
        matches across requests; the request object itself is never
        mutated, so the same workload can be replayed against a sharing
        server afterwards."""
        if self.prefix_trie is None and salt == 0:
            return rid + 1
        return salt

    def register_prefix(self, tokens: Sequence[int]) -> None:
        """Index a served sequence so later requests can share its prefix."""
        if self.prefix_trie is not None:
            self.prefix_trie.insert(tokens)

    def match_shared_prefix(self, tokens: Sequence[int],
                            hashes: List[int]) -> Tuple[int, Optional[int]]:
        """Longest previously-served prefix of ``tokens`` and, when it ends
        mid-block, a resident donor slot for the copy-on-write fork.

        Returns ``(matched_tokens, donor_slot)``.  Full blocks inside the
        match are found by the ordinary hash-table :meth:`match`; only the
        trailing partial block needs the donor.  ``hashes`` must be the
        caller's salt-0 chain hashes (sharing is only defined in the
        shared namespace)."""
        if self.prefix_trie is None or not tokens:
            return 0, None
        pm = self.prefix_trie.match(tokens)
        matched = min(pm.length, len(tokens))
        if matched == 0:
            return 0, None
        self.n_prefix_matches += 1
        self.prefix_tokens_matched += matched
        bs = self.block_size
        b, rem = divmod(matched, bs)
        if rem == 0:
            return matched, None
        # donor block b covers positions [b*bs, (b+1)*bs); its first `rem`
        # positions' K/V are valid for us (identical token prefix).  Its
        # chain hash needs the donor's own continuation tokens.
        need = bs - rem
        common = tuple(tokens[b * bs:matched])
        prev = hashes[b - 1] if b > 0 else hash_seed(0)
        for completion in self.prefix_trie.completions(pm, need):
            slot = self.table.get(chain_hash(prev, common + completion))
            if slot is not None:
                return matched, slot
        return matched, None

    def fork_into(self, src_slot: int, dst_slot: int, now: float) -> None:
        """Copy-on-write fork: schedule a device page copy ``src -> dst``.

        The source is acquired (ref-counted) so it cannot be evicted before
        the engine drains the copy; the caller releases it via the slots
        returned by :meth:`drain_pending_copies`."""
        self._acquire(src_slot, now)
        self.pending_copies.append((src_slot, dst_slot))
        self.n_cow_forks += 1

    def drain_pending_copies(self) -> List[Tuple[int, int]]:
        """Hand the queued (src, dst) page copies to the engine.  The caller
        must ``release`` the src slots once the copies have executed."""
        out, self.pending_copies = self.pending_copies, []
        return out

    # ------------------------------------------------------------------
    # allocation / eviction
    # ------------------------------------------------------------------
    def num_free(self) -> int:
        return len(self.free) + len(self.policy)

    # ------------------------------------------------------------------
    # shard accounting (sharded serving engine)
    # ------------------------------------------------------------------
    def shard_of(self, slot: int) -> int:
        """Device shard owning pool page ``slot`` (contiguous runs)."""
        return slot // self.shard_size

    def per_shard_used(self) -> List[int]:
        """Resident (non-free-list) pages per shard.  Evictable-but-
        resident blocks count as used: they hold live KV content."""
        used = [self.shard_size] * self.n_shards
        for slot in self.free:
            used[self.shard_of(slot)] -= 1
        return used

    def _pop_striped_batch(self, n: int) -> List[int]:
        """Pop up to ``n`` free slots balancing shard occupancy: each pick
        prefers the most-free shard, round-robin on ties, so the blocks
        of one allocation stripe across shards.  ONE partition of the
        free list per call (O(num_free + n·n_shards)), not per block —
        ``self.free`` stays the single source of truth between calls."""
        free_by: List[List[int]] = [[] for _ in range(self.n_shards)]
        for slot in self.free:
            free_by[self.shard_of(slot)].append(slot)
        out: List[int] = []
        last = -1
        while len(out) < n:
            best, best_key = -1, None
            for d in range(1, self.n_shards + 1):
                s = (last + d) % self.n_shards
                if free_by[s] and (best_key is None
                                   or len(free_by[s]) > best_key):
                    best, best_key = s, len(free_by[s])
            if best < 0:
                break
            out.append(free_by[best].pop())
            last = best
        self.free = [s for lst in free_by for s in lst]
        return out

    def allocate(self, n: int, now: float) -> Optional[List[int]]:
        """Allocate ``n`` fresh blocks, evicting if necessary.

        Returns None (allocating nothing) if the pool can't satisfy it —
        the scheduler must defer the request.  With ``n_shards > 1`` free
        slots are taken striped across shards (most-free first, round-
        robin on ties) so sequences sequence-shard across devices."""
        if self.num_free() < n:
            return None
        out: List[int] = []
        if self.n_shards > 1:
            out = self._pop_striped_batch(n)
        for _ in range(n - len(out)):
            if self.free:
                slot = self.free.pop()
            else:
                slot = self.policy.evict(now)
                assert slot is not None
                self._erase(slot, now)
                self.n_evictions += 1
            out.append(slot)
        for slot in out:
            # a reallocated slot is new content: it must not count as a
            # realized prefetch hit for whatever used to live there
            self.prefetch_slots.pop(slot, None)
            blk = self.blocks[slot]
            blk.key = None
            blk.ref_count = 1
            blk.peak_ref = 1
            blk.count = 1.0
            blk.boost = 1.0
            blk.v_pending = False
            blk.last_access = now
        return out

    def _erase(self, slot: int, now: float = 0.0) -> None:
        blk = self.blocks[slot]
        if blk.key is None:
            return
        key = blk.key
        self.evicted_positions.append(blk.block_pos)
        self.table.pop(key, None)
        was_v_pending = blk.v_pending
        blk.v_pending = False
        self._host_pinned.pop(key, None)
        ck = None
        if self.store is not None and self.store.enabled:
            ck = self._content_of.get(key)
        if self.host_blocks > 0:
            e = self.host_tier.get(key)
            # committed block content is immutable (content-addressed by
            # chain hash), so any half the host already holds is still
            # valid: spill ONLY the missing halves.  A clean spill moves
            # zero bytes AND skips the synchronous device pool read.  A
            # v_pending block's V half never left the host.
            need_k = e is None or e.k is None
            need_v = (e is None or e.v is None) and not was_v_pending
            k_raw = v_raw = None
            if self.swap_out_fn is not None:
                # always called even when nothing is needed: besides
                # reading the needed halves, the engine purges any
                # still-queued swap-in halves for this slot (the
                # evict-while-queued fix) so a late in-step scatter can't
                # clobber the reallocated page
                k_raw, v_raw = self.swap_out_fn(slot, need_k, need_v)
            if e is None:
                e = HostEntry(block_pos=blk.block_pos)
                self.host_tier[key] = e
            if need_k:
                e.k = self._encode_half(k_raw, key, "k")
                self.bytes_swapped_out_k += e.k.nbytes
                self.host_resident_bytes += e.k.nbytes
            else:
                self.n_clean_half_spills += 1
            if need_v:
                e.v = self._encode_half(v_raw, key, "v")
                self.bytes_swapped_out_v += e.v.nbytes
                self.host_resident_bytes += e.v.nbytes
            else:
                self.n_clean_half_spills += 1
            if ck is not None and e.complete:
                # content is restart-stable: deposit under the content
                # key too (the store clones; tier mutations can't reach
                # the stored copy).  A quota rejection just recomputes.
                self.store.deposit(ck, e, self._owner_of(ck), now)
            self.host_tier.move_to_end(key)
            self.n_swap_outs += 1
            self._enforce_host_budget()
        elif ck is not None:
            # no host tier configured, but the global store is on: read
            # both halves and deposit straight to the store (the read
            # also purges any still-queued swap-in halves for the slot)
            k_raw = v_raw = None
            if self.swap_out_fn is not None:
                k_raw, v_raw = self.swap_out_fn(slot, True, True)
            e = HostEntry(block_pos=blk.block_pos,
                          k=self._encode_half(k_raw, key, "k"),
                          v=self._encode_half(v_raw, key, "v"))
            self.store.deposit(ck, e, self._owner_of(ck), now)
        blk.key = None

    # ------------------------------------------------------------------
    # host-tier internals (split K/V residency + quantized payloads)
    # ------------------------------------------------------------------
    def _host_has(self, key: int, which: str) -> bool:
        e = self.host_tier.get(key)
        return e is not None and getattr(e, which) is not None

    def _host_complete(self, key: int) -> bool:
        e = self.host_tier.get(key)
        return e is not None and e.complete

    # ------------------------------------------------------------------
    # content-addressed global prefix store bridge (core/prefix_store)
    # ------------------------------------------------------------------
    @property
    def host_restore_active(self) -> bool:
        """True when host→device swap-ins can happen at admission: a
        host tier is configured OR the global prefix store can stage
        entries into the (otherwise budget-less) tier."""
        return self.host_blocks > 0 or \
            (self.store is not None and self.store.enabled)

    def content_keys(self, tokens: Sequence[int]) -> Optional[List[bytes]]:
        """Restart-stable content keys for each full block (the content
        analogue of :meth:`block_hashes`); None when no store is wired."""
        if self.store is None or not self.store.enabled:
            return None
        return self.store.keys_for(tokens, self.block_size)

    def _owner_of(self, ck: bytes) -> str:
        return self.store.owner_hint(ck)

    def _note_content(self, key: int, ck: bytes, tenant: str,
                      block_pos: int) -> None:
        """Cache the chain-hash→content-key resolution (bounded LRU) and
        register the tenant's interest so later deposits attribute
        ownership to every tenant sharing the prefix."""
        self._content_of[key] = ck
        self._content_of.move_to_end(key)
        while len(self._content_of) > self._content_cap:
            self._content_of.popitem(last=False)
        self.store.register(ck, tenant, block_pos)

    def _store_fetch(self, ck: bytes, key: int, tenant: str,
                     now: float) -> bool:
        """Resolve a table+host-tier miss against the global prefix
        store.  A hit stages the payload into the host tier under the
        CURRENT chain hash and reports a host hit — the ordinary
        admission swap-in path then restores it into a device slot.
        The fetch runs the same fault gauntlet as any host acquire
        (``host_corrupt`` site + checksum verification); a corrupt
        payload is purged from the store and the block recomputed
        (§4 lossless)."""
        entry = self.store.acquire(ck, tenant, now)
        if entry is None:
            return False
        if self.faults is not None and self.faults.should_fire("host_corrupt"):
            self._corrupt_entry(entry)
        if not (verify_half(entry.k) and verify_half(entry.v)):
            self.n_host_corruptions += 1
            self.store.drop_corrupt(ck)
            self.store.release(ck)
            self.audit_after_fault()
            return False
        self.host_tier[key] = entry
        self.host_resident_bytes += entry.nbytes
        self.host_tier.move_to_end(key)
        if self.host_blocks > 0:
            # staged entry competes under the normal byte budget; it was
            # just moved to the MRU end, so it is shed last — and if it
            # IS shed, the admission swap-in misses and recomputes
            self._enforce_host_budget()
        self.store.release(ck)
        return self._host_complete(key)

    def export_resident(self, now: float) -> int:
        """Deposit every committed block with a known content key into
        the global prefix store: device-resident blocks are read via
        ``swap_out_fn`` (non-destructive pool read), complete host-tier
        entries deposit directly.  Called by the server's snapshot path
        AFTER serve() drains (the pool read also purges queued swap
        halves, which must be empty by then).  Returns deposits made."""
        if self.store is None or not self.store.enabled:
            return 0
        n = 0
        for key, slot in list(self.table.items()):
            ck = self._content_of.get(key)
            blk = self.blocks[slot]
            if ck is None or blk.v_pending:
                continue
            k_raw = v_raw = None
            if self.swap_out_fn is not None:
                k_raw, v_raw = self.swap_out_fn(slot, True, True)
            e = HostEntry(block_pos=blk.block_pos,
                          k=self._encode_half(k_raw, key, "k"),
                          v=self._encode_half(v_raw, key, "v"))
            if self.store.deposit(ck, e, self._owner_of(ck), now):
                n += 1
        for key, e in list(self.host_tier.items()):
            ck = self._content_of.get(key)
            if ck is not None and e.complete and \
                    self.store.deposit(ck, e, self._owner_of(ck), now):
                n += 1
        return n

    def _encode_half(self, raw, key: int, which: str) -> HostHalf:
        """Wire-encode one spilled half.  ``raw`` is None (simulation /
        no engine: account the configured wire size), an ndarray read
        from the device pool (quantize per config), or already a
        :class:`HostHalf` (the evict-while-queued intercept returned the
        queued wire half verbatim — kept bit-exact by identity, no
        requantization)."""
        idx = 0 if which == "k" else 1
        fmt = self.offload.wire_format
        if isinstance(raw, HostHalf):
            return self._seal_half(raw)
        if raw is None:
            return self._seal_half(HostHalf(
                data=None, scale=None,
                nbytes=self._wire_half_bytes[idx], fmt=fmt))
        arr = np.asarray(raw)
        if fmt != "q8":
            return self._seal_half(quantize_half(arr, fmt))
        if self.offload.lossy_offload:
            # exact-requantization bookkeeping: restored content re-spills
            # with its remembered scale, recovering identical codes
            hh = quantize_half(arr, "q8",
                               scale=self._scales.get(key, which))
            self._scales.put(key, which, hh.scale)
            return self._seal_half(hh)
        # lossless: pool values were snapped to this static grid at write
        # time, so the round-trip is exact by construction
        return self._seal_half(
            quantize_half(arr, "q8", static_scale=self._grid_scale))

    def _seal_half(self, hh: HostHalf) -> HostHalf:
        """Stamp a spilled half with its payload checksum (verified again
        at acquire) when payload verification is active."""
        if self._checksums and hh.checksum is None:
            hh.checksum = half_checksum(hh)
        return hh

    def _consume_entry(self, key: int) -> None:
        """Remove a host entry that was swapped back in (not an LRU drop)."""
        e = self.host_tier.pop(key, None)
        if e is not None:
            self.host_resident_bytes -= e.nbytes

    def _drop_entry(self, key: int) -> None:
        e = self.host_tier.pop(key)
        self.host_resident_bytes -= e.nbytes
        self.n_host_evictions += 1

    def _keep_k(self, e: HostEntry) -> bool:
        """§4 per-half swap-vs-recompute: keep a deep-position K half
        whose host restore beats its share of the block's recompute."""
        return self.cost_model.half_offload_gain(
            e.block_pos * self.block_size, self.block_size,
            e.k.nbytes, self.pcie_bw) > 0.0

    def _enforce_host_budget(self) -> None:
        """LRU walk shedding host bytes down to the budget.  With
        ``keep_k_half`` the V half goes first (Kcache asymmetry) and a
        positive-gain K half survives as a re-aged remnant; a second
        pass drops remnants if the budget is still exceeded.  Halves
        pinned by in-flight k-early completions are never dropped (their
        count is bounded by outstanding prefetches)."""
        skipped = 0
        while self.host_resident_bytes > self._host_budget \
                and skipped < len(self.host_tier):
            key = next(iter(self.host_tier))
            e = self.host_tier[key]
            if key in self._host_pinned:
                self.host_tier.move_to_end(key)
                skipped += 1
                continue
            if self.offload.keep_k_half and e.v is not None:
                self.host_resident_bytes -= e.v.nbytes
                e.v = None
                self.n_host_half_drops += 1
                if e.k is not None and self._keep_k(e):
                    self.host_tier.move_to_end(key)     # K remnant
                    skipped += 1
                    continue
            self._drop_entry(key)
        if self.host_resident_bytes <= self._host_budget:
            return
        for key in list(self.host_tier):
            if self.host_resident_bytes <= self._host_budget:
                return
            if key not in self._host_pinned:
                self._drop_entry(key)

    def _complete_v_half(self, slot: int, blk: Block) -> None:
        """Stream the on-demand V half of a k-early-prefetched block
        through the in-step swap queue.  ``match`` already verified the
        host V half exists (it was pinned against budget drops)."""
        key = blk.key
        e = self.host_tier[key]
        vh = e.v
        if self.swap_in_fn is not None and vh.data is not None:
            self.swap_in_fn(slot, (None, vh))
        self.bytes_swapped_in_v += vh.nbytes
        self.n_v_half_streams += 1
        blk.v_pending = False
        self._host_pinned.pop(key, None)
        if self.offload.retain_host:
            self.host_tier.move_to_end(key)
        else:
            self._consume_entry(key)

    def _purge_pending_block(self, key: int, slot: int) -> None:
        """A v_pending block whose host V half vanished can never be
        completed: unmap it so the request recomputes it losslessly."""
        blk = self.blocks[slot]
        self.table.pop(key, None)
        self.prefetch_slots.pop(slot, None)
        self._host_pinned.pop(key, None)
        blk.v_pending = False
        blk.key = None
        blk.pinned_until = -math.inf
        self.n_pending_purges += 1
        if self.swap_out_fn is not None:
            # purge any still-queued K half for the slot before freeing it
            self.swap_out_fn(slot, False, False)
        if slot in self.policy:
            self.policy.remove(slot)
        if blk.ref_count == 0:
            self.free.append(slot)

    def counters(self) -> Dict[str, int]:
        """Deterministic host-tier/offload accounting, merged verbatim
        into every server result (frozen in tests/test_perf_counters)."""
        return {
            "swap_ins": self.n_swap_ins,
            "swap_outs": self.n_swap_outs,
            "evictions": self.n_evictions,
            "bytes_swapped_in_k": self.bytes_swapped_in_k,
            "bytes_swapped_in_v": self.bytes_swapped_in_v,
            "bytes_swapped_out_k": self.bytes_swapped_out_k,
            "bytes_swapped_out_v": self.bytes_swapped_out_v,
            "host_resident_bytes": self.host_resident_bytes,
            "host_entries": len(self.host_tier),
            "n_host_evictions": self.n_host_evictions,
            "n_host_half_drops": self.n_host_half_drops,
            "clean_half_spills": self.n_clean_half_spills,
            "v_half_streams": self.n_v_half_streams,
            "k_early_prefetches": self.n_k_early_prefetches,
            "pending_purges": self.n_pending_purges,
        }

    def commit(self, slot: int, key: int, block_pos: int) -> None:
        """Register a filled block in the hash table (reusable from now)."""
        blk = self.blocks[slot]
        old = self.table.get(key)
        if old is not None and old != slot:
            # duplicate content (two requests computed the same block
            # concurrently): keep the existing mapping
            return
        blk.key = key
        blk.block_pos = block_pos
        self.table[key] = slot

    def release(self, slots: Sequence[int], now: float) -> None:
        """Drop one reference from each block; ref==0 -> evictable."""
        for slot in slots:
            blk = self.blocks[slot]
            assert blk.ref_count > 0, slot
            blk.ref_count -= 1
            if blk.ref_count == 0:
                if blk.key is None:
                    self.free.append(slot)   # never committed: plain free
                elif now >= blk.pinned_until:
                    self._make_evictable(slot, now)
                # else: stays pinned; unpin() will enqueue it

    def _make_evictable(self, slot: int, now: float) -> None:
        blk = self.blocks[slot]
        log_cost = self.cost_model.log_block_cost(
            blk.block_pos * self.block_size, self.block_size)
        if self.offload.swap_aware_eviction and blk.key is not None \
                and self._host_complete(blk.key):
            # retained host copy: evicting this block costs only the
            # cheaper of recompute and swap-restore (§4, per-half bytes)
            e = self.host_tier[blk.key]
            log_cost = math.log(max(self.cost_model.restore_cost(
                blk.block_pos * self.block_size, self.block_size,
                e.nbytes, self.pcie_bw), 1e-12))
        # shared-block savings: a block k requests mapped concurrently is
        # worth k recomputations if evicted -> weight its cost by peak_ref
        self.policy.add(slot, EvictableMeta(
            last_access=blk.last_access,
            log_cost=log_cost + math.log(blk.boost * max(blk.peak_ref, 1)),
            count=blk.count))

    # ------------------------------------------------------------------
    # Continuum-style TTL pinning (§5.2 / §6.5)
    # ------------------------------------------------------------------
    def pin(self, slots: Sequence[int], until: float) -> None:
        for slot in slots:
            blk = self.blocks[slot]
            blk.pinned_until = max(blk.pinned_until, until)
            heapq.heappush(self._pin_heap, (blk.pinned_until, slot))
            self.n_pin_heap_ops += 1
            if blk.ref_count == 0 and blk.key is not None:
                self.policy.remove(slot)

    def unpin_expired(self, now: float) -> None:
        """Release every pin that has expired by ``now``.  Cost is
        O(expired · log pins) via the lazy pin heap — NOT a scan of the
        whole pool, which at stress-scale session counts dominated the
        per-step control plane."""
        heap = self._pin_heap
        while heap and heap[0][0] <= now:
            until, slot = heapq.heappop(heap)
            self.n_pin_heap_ops += 1
            blk = self.blocks[slot]
            if blk.pinned_until != until:
                continue               # stale: re-pinned later or unpinned
            blk.pinned_until = -math.inf
            if blk.ref_count == 0 and blk.key is not None and \
                    slot not in self.policy:
                self._make_evictable(slot, now)

    def swap_in(self, key: int, slot: int, block_pos: int,
                now: float) -> bool:
        """Restore a host-tier block into device slot ``slot`` (paper §7).

        Returns False when the key is gone — ``match()`` records host hits
        BEFORE ``allocate()`` runs, and the evictions allocate triggers
        spill fresh blocks into the host tier, whose LRU may push the
        matched key out in between.  The caller must then leave the block
        as a gap (recomputed losslessly) instead of marking it hit.

        Only a COMPLETE entry (both halves host-resident) can restore a
        block.  With ``retain_host`` the entry stays in the tier after
        the swap-in — committed content is immutable, so the copy stays
        valid and the block's next eviction becomes a clean spill."""
        e = self.host_tier.get(key)
        if e is None or not e.complete:
            return False
        if not self._survive_acquire(key, e):
            return False
        if self.swap_in_fn is not None and \
                (e.k.data is not None or e.v.data is not None):
            self.swap_in_fn(slot, (e.k, e.v))
        self.bytes_swapped_in_k += e.k.nbytes
        self.bytes_swapped_in_v += e.v.nbytes
        self.commit(slot, key, block_pos)
        self.n_swap_ins += 1
        if self.offload.retain_host:
            self.host_tier.move_to_end(key)
        else:
            self._consume_entry(key)
        return True

    def _swap_in_k_half(self, key: int, slot: int, block_pos: int,
                        now: float) -> bool:
        """K-early prefetch restore: ship only the K half now, commit the
        block with ``v_pending`` set, and pin the host V half so it
        survives until the block is acquired (V then streams on demand
        via :meth:`_acquire`) or evicted."""
        e = self.host_tier.get(key)
        if e is None or not e.complete:
            return False
        if not self._survive_acquire(key, e):
            return False
        if self.swap_in_fn is not None and e.k.data is not None:
            self.swap_in_fn(slot, (e.k, None))
        self.bytes_swapped_in_k += e.k.nbytes
        self.commit(slot, key, block_pos)
        self.blocks[slot].v_pending = True
        self._host_pinned[key] = slot
        self.host_tier.move_to_end(key)
        self.n_swap_ins += 1
        self.n_k_early_prefetches += 1
        return True

    # ------------------------------------------------------------------
    # fault injection + graceful degradation (core/faults.py)
    # ------------------------------------------------------------------
    def _survive_acquire(self, key: int, e: HostEntry) -> bool:
        """Host-payload fault gauntlet at acquire time.  Returning False
        degrades to the §4 lossless recompute path (the caller leaves
        the block as a gap, exactly like a host-tier miss):

        * ``swap_in_loss`` — payload lost in transit.  Transient: the
          read is retried up to ``swap_retry_limit`` times (each retry
          re-arms the site, so a persistent fault keeps firing); a loss
          that survives every retry drops the entry and misses.
        * ``host_corrupt`` — the stored payload is flipped, then the
          normal checksum verification (active whenever checksums are)
          catches the mismatch: the entry is dropped and the block
          recomputed rather than serving corrupt KV bytes.
        """
        if self.faults is not None:
            lost = self.faults.should_fire("swap_in_loss")
            tries = 0
            while lost and tries < self.swap_retry_limit:
                tries += 1
                self.n_swap_in_retries += 1
                lost = self.faults.should_fire("swap_in_loss")
            if lost:
                self.n_swap_in_losses += 1
                self._consume_entry(key)
                self.audit_after_fault()
                return False
            if self.faults.should_fire("host_corrupt"):
                self._corrupt_entry(e)
        if self._checksums and not (verify_half(e.k) and verify_half(e.v)):
            self.n_host_corruptions += 1
            self._consume_entry(key)
            self.audit_after_fault()
            return False
        return True

    @staticmethod
    def _corrupt_entry(e: HostEntry) -> None:
        """Flip one payload byte of the entry (simulated payloads flip
        the stored checksum instead) so verification must reject it."""
        hh = e.k if e.k is not None else e.v
        if hh.data is not None:
            hh.data = hh.data.copy()
            hh.data.view(np.uint8).reshape(-1)[0] ^= 0xFF
        else:
            hh.checksum = (hh.checksum or 0) ^ 0x1

    def drop_copies_to(self, slots, now: float) -> int:
        """Cancel queued copy-on-write copies into ``slots`` (a failed or
        cancelled request's pages): the dst is about to be released, so
        draining the copy later would scatter into a reallocated page.
        Donor refs are dropped here.  Returns copies cancelled."""
        targets = set(slots)
        kept: List[Tuple[int, int]] = []
        dropped = 0
        for src, dst in self.pending_copies:
            if dst in targets:
                self.release([src], now)
                dropped += 1
            else:
                kept.append((src, dst))
        self.pending_copies = kept
        return dropped

    def audit_after_fault(self) -> None:
        """Run the full invariant audit right after an injected fault —
        every fault site calls this, so a chaos run that corrupts the
        accounting fails loudly at the fault, not at drain."""
        if self.faults is not None:
            self.check_invariants()

    def check_invariants(self) -> Dict[str, int]:
        """Audit the cross-structure accounting and raise AssertionError
        on any violation.  The partition invariant: every pool slot is
        in exactly one of {free list, evictable set, referenced
        (ref_count > 0), pinned-resident at refcount 0}; the hash table
        is a bijection onto committed resident blocks; host-tier byte
        accounting matches the entries; k-early pins point at v_pending
        blocks whose host V half survives.  Runnable every
        ``audit_every`` steps (ServerConfig) and after every injected
        fault; returns the partition census."""
        self.n_invariant_audits += 1
        free = set(self.free)
        assert len(free) == len(self.free), "duplicate slots on free list"
        n_referenced = n_evictable = n_pinned0 = 0
        for blk in self.blocks:
            assert blk.ref_count >= 0, (blk.slot, blk.ref_count)
            in_policy = blk.slot in self.policy
            if blk.slot in free:
                assert blk.ref_count == 0 and blk.key is None \
                    and not in_policy, f"free slot {blk.slot} still live"
                continue
            if in_policy:
                assert blk.ref_count == 0 and blk.key is not None, \
                    f"evictable slot {blk.slot} referenced or uncommitted"
                n_evictable += 1
            elif blk.ref_count > 0:
                n_referenced += 1
            else:
                # resident at refcount 0 outside the evictable set: only
                # a pin (live, or expired awaiting its lazy sweep) may
                # hold a block there
                assert blk.key is not None and \
                    blk.pinned_until > -math.inf, \
                    f"slot {blk.slot} leaked (ref 0, unpinned, not free)"
                n_pinned0 += 1
            if blk.key is not None:
                assert self.table.get(blk.key) == blk.slot, \
                    f"slot {blk.slot} committed but not in table"
            if blk.v_pending:
                assert blk.key is not None \
                    and blk.key in self._host_pinned, \
                    f"v_pending slot {blk.slot} without host pin"
        assert len(free) + n_referenced + n_evictable + n_pinned0 \
            == self.num_blocks, "slot partition does not cover the pool"
        for key, slot in self.table.items():
            assert self.blocks[slot].key == key, \
                f"table maps {key} to slot {slot} holding other content"
        total = sum(e.nbytes for e in self.host_tier.values())
        assert total == self.host_resident_bytes, \
            (total, self.host_resident_bytes)
        if self.host_blocks > 0:
            pinned_bytes = sum(
                self.host_tier[k].nbytes
                for k in self._host_pinned if k in self.host_tier)
            assert self.host_resident_bytes \
                <= self._host_budget + pinned_bytes, \
                "host tier over budget beyond pinned halves"
        for key, slot in self._host_pinned.items():
            blk = self.blocks[slot]
            assert blk.key == key and blk.v_pending, \
                f"host pin {key} -> slot {slot} out of sync"
            assert self._host_has(key, "v"), \
                f"pinned host V half for {key} vanished"
        for slot in self.prefetch_slots:
            assert self.blocks[slot].key is not None, \
                f"prefetch slot {slot} uncommitted"
        for src, _dst in self.pending_copies:
            assert self.blocks[src].ref_count > 0, \
                f"pending copy source {src} unreferenced"
        assert all(0 <= u <= self.shard_size
                   for u in self.per_shard_used()), \
            "per-shard occupancy out of range (free slot outside pool?)"
        if self.store is not None:
            # tenant-quota / byte accounting of the global prefix store
            # audits with the rest of the cross-structure invariants
            self.store.check_invariants()
        return {"free": len(free), "referenced": n_referenced,
                "evictable": n_evictable, "pinned_ref0": n_pinned0}

    def fault_counters(self) -> Dict[str, int]:
        """Degradation accounting, merged into every server result
        (separate from the frozen :meth:`counters` schema)."""
        return {
            "swap_in_losses": self.n_swap_in_losses,
            "swap_in_retries": self.n_swap_in_retries,
            "host_corruptions": self.n_host_corruptions,
            "invariant_audits": self.n_invariant_audits,
        }

    # ------------------------------------------------------------------
    # predictive host-tier prefetch (online session serving / Continuum)
    # ------------------------------------------------------------------
    def prefetch(self, hashes: Sequence[int], now: float, until: float,
                 boost: float = 1.0,
                 owner: Optional[int] = None) -> Dict[str, int]:
        """Restore a suspended session's blocks toward the device ahead of
        its predicted resume (the lifespan-driven prefetch of the online
        frontend).  For each chain hash, in two passes:

          1. already device-resident  → TTL-pin until ``until`` so it
             cannot be evicted before the resume;
          2. in the host tier         → allocate a device slot, swap the
             payload back in (queued into the engine's in-step swap
             bucket via ``swap_in_fn``, so it lands inside the next
             dispatched step, before any attention that reads it), commit
             and pin.  The transient allocation reference is dropped
             right away — the pin alone keeps the block resident.

        Pass 1 runs fully before pass 2 because pass 2's allocations may
        evict; pinning the survivors first keeps them out of the victim
        set.  Blocks in neither tier are counted as misses (the resumed
        turn will recompute them losslessly); allocation failure under
        pool exhaustion makes the prefetch best-effort, never an error.
        Every restored/pinned slot joins ``prefetch_slots`` under
        ``owner`` (the suspended session's id) so the resume admission's
        ``_acquire`` can count realized prefetch hits and drop the
        then-served pin — only for the OWNING session; a shared-prefix
        block hit by a foreign session keeps its pin until the owner
        resumes, the TTL expires, or :meth:`cancel_prefetch` aborts it.
        A block two sessions prefetch belongs to the later call (the
        earlier owner's resume then simply leaves the pin to expire).
        Returns this call's counts."""
        out = {"pinned": 0, "swapped_in": 0, "missed": 0, "alloc_failed": 0}
        host_wanted: List[Tuple[int, int]] = []
        for b, h in enumerate(hashes):
            self.n_prefetch_issued += 1
            slot = self.table.get(h)
            if slot is not None:
                self.pin([slot], until)
                if boost > 1.0:
                    self.blocks[slot].boost = max(
                        self.blocks[slot].boost, boost)
                self.prefetch_slots[slot] = owner
                self.n_prefetch_pins += 1
                out["pinned"] += 1
            elif self._host_complete(h):
                host_wanted.append((b, h))
            else:
                self.n_prefetch_misses += 1
                out["missed"] += 1
        for b, h in host_wanted:
            fresh = self.allocate(1, now)
            if fresh is None:
                self.n_prefetch_alloc_fail += 1
                out["alloc_failed"] += 1
                continue
            slot = fresh[0]
            restore = (self._swap_in_k_half
                       if self.offload.k_early_prefetch else self.swap_in)
            if not restore(h, slot, b, now):
                # this loop's own allocations spill evictions into the
                # host LRU, which may have pushed h out since pass 1 —
                # degrade to recompute, exactly like the admission path
                self.release([slot], now)
                self.n_prefetch_misses += 1
                out["missed"] += 1
                continue
            self.n_prefetch_swap_ins += 1
            self.pin([slot], until)
            if boost > 1.0:
                self.blocks[slot].boost = max(self.blocks[slot].boost, boost)
            self.prefetch_slots[slot] = owner
            self.release([slot], now)   # pinned: resident at refcount 0
            out["swapped_in"] += 1
        return out

    def realize_prefetch(self, slots: Sequence[int],
                         owner: Optional[int] = None) -> int:
        """Mark prefetched blocks as USED by a successfully admitted
        request: count the realized hits and drop the now-served resume
        pins.  Only slots the ``owner`` session owns (or unowned
        prefetches) are realized — a FOREIGN session acquiring a
        shared-prefix block leaves entry and pin intact, because the
        owner's resume is still pending and the pin is its only
        protection once the foreigner releases.  Called by the scheduler
        AFTER admission succeeds (never on the match of a deferred
        admission, whose rollback must leave the pins standing)."""
        n = 0
        for slot in slots:
            pf_owner = self.prefetch_slots.get(slot, -1)
            if pf_owner != -1 and (pf_owner is None or pf_owner == owner):
                self.prefetch_slots.pop(slot)
                self.n_prefetch_hits += 1
                self.blocks[slot].pinned_until = -math.inf
                n += 1
        return n

    def cancel_prefetch(self, hashes: Sequence[int], now: float,
                        owner: Optional[int] = None) -> int:
        """Drop the resume pins of a cancelled session's prefetched blocks
        so a dead job stops holding device memory: each still-prefetched
        slot OWNED by ``owner`` is unpinned and (at refcount 0) returned
        to the evictable set.  A shared-prefix block meanwhile re-owned
        by another suspended session's prefetch is left alone.  Returns
        blocks freed."""
        n = 0
        for h in hashes:
            slot = self.table.get(h)
            if slot is None or slot not in self.prefetch_slots:
                continue
            if self.prefetch_slots[slot] != owner:
                continue                  # another session's pin now
            self.prefetch_slots.pop(slot)
            blk = self.blocks[slot]
            blk.pinned_until = -math.inf
            if blk.ref_count == 0 and blk.key is not None \
                    and slot not in self.policy:
                self._make_evictable(slot, now)
            n += 1
        return n

    def prefetch_counters(self) -> Dict[str, int]:
        """Deterministic prefetch accounting (benchmarks/agentic_online)."""
        return {
            "prefetch_issued": self.n_prefetch_issued,
            "prefetch_pins": self.n_prefetch_pins,
            "prefetch_swap_ins": self.n_prefetch_swap_ins,
            "prefetch_hits": self.n_prefetch_hits,
            "prefetch_misses": self.n_prefetch_misses,
            "prefetch_alloc_fail": self.n_prefetch_alloc_fail,
        }

    def earliest_pin_expiry(self, now: float) -> Optional[float]:
        """Soonest pin expiry strictly after ``now`` (lazy pin heap:
        stale entries are dropped on the way down; entries already
        expired by ``now`` are released exactly as unpin_expired
        would)."""
        heap = self._pin_heap
        while heap:
            until, slot = heap[0]
            blk = self.blocks[slot]
            if blk.pinned_until != until:
                heapq.heappop(heap)                 # stale
                self.n_pin_heap_ops += 1
                continue
            if until > now:
                return until
            heapq.heappop(heap)
            self.n_pin_heap_ops += 1
            blk.pinned_until = -math.inf
            if blk.ref_count == 0 and blk.key is not None and \
                    slot not in self.policy:
                self._make_evictable(slot, now)
        return None

    def control_plane_counts(self) -> Dict[str, int]:
        """Deterministic per-structure op counts for the control-plane
        stress gates (benchmarks/control_plane_stress.py): divided by
        scheduled steps, each must stay sublinear in resident sessions."""
        from repro_torch.core.evictor import policy_op_counts
        out = dict(policy_op_counts(self.policy))
        out["evictor_reranks"] = self.n_evictor_reranks
        out["trie_nodes_visited"] = (
            self.prefix_trie.n_nodes_visited
            if self.prefix_trie is not None else 0)
        out["pin_heap_ops"] = self.n_pin_heap_ops
        return out

    def set_boost(self, slots: Sequence[int], boost: float) -> None:
        """Agentic correction factor (§5.2): tool-call-pending blocks.

        A block already sitting in the evictable set was enqueued with
        its OLD boost baked into the policy meta (``_make_evictable``
        folds it into log_cost), so it is re-enqueued — otherwise the
        online frontend's suspend-time boost (applied right after the
        finished turn's release) would never reach the eviction
        ranking."""
        for slot in slots:
            blk = self.blocks[slot]
            blk.boost = boost
            if blk.ref_count == 0 and blk.key is not None \
                    and slot in self.policy:
                self.n_evictor_reranks += 1
                self.policy.remove(slot)
                self._make_evictable(slot, blk.last_access)

    # ------------------------------------------------------------------
    def hit_rate(self) -> float:
        return self.n_hits / max(self.n_lookups, 1)

    def resident_tokens(self) -> int:
        return len(self.table) * self.block_size
