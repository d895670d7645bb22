"""Adaptive chunking scheduler (paper §5.1) + continuous batching.

Each scheduling step builds a ``StepPlan`` containing
  * up to ``max_prefills`` prefill chunks — each chunk is the next run of a
    request's *compute list* (the logical positions whose KV must be
    (re)computed), which may span several cache gaps → a genuinely
    multi-segment chunk handled by one MSA dispatch;
  * every running decode request (one token each).

Adaptive chunk sizing: when the number of co-scheduled decodes exceeds
``decode_threshold`` the per-request chunk shrinks (never below
``min_chunk``) so decode TPOT is protected; prefill total latency is
roughly unchanged because prefill is compute-bound (§5.1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.block_manager import BlockManager
from repro_torch.serving.request import Request, RequestState


@dataclass
class PrefillChunk:
    req: Request
    positions: np.ndarray         # logical positions computed this step
    completes_prefill: bool


@dataclass
class StepPlan:
    prefills: List[PrefillChunk] = field(default_factory=list)
    decodes: List[Request] = field(default_factory=list)
    # occupancy buckets chosen for this step (fused engine layout): the
    # smallest lattice entries that fit the step's compute tokens and
    # deepest page table.  None = engine picks (identical lattice).
    t_bucket: Optional[int] = None
    np_bucket: Optional[int] = None
    # multi-token decode dispatch: how many fused decode iterations the
    # engine runs inside ONE jitted call (1 = the ordinary single-step
    # plan).  Only ever > 1 for decode-only plans (no prefill chunks).
    decode_steps: int = 1
    # per decode request: iterations it actually consumes inside a
    # decode_steps > 1 plan — min(decode_steps, remaining output tokens).
    # Iterations past a request's remaining output are masked on device
    # (no KV write) and rolled back on the host (their sampled ids are
    # simply never consumed).  Empty when decode_steps == 1.
    decode_iters: List[int] = field(default_factory=list)

    @property
    def n_compute_tokens(self) -> int:
        """Compute tokens per engine ITERATION (the token-stream width the
        t_bucket must cover — not multiplied by decode_steps)."""
        return sum(len(c.positions) for c in self.prefills) + len(self.decodes)

    @property
    def total_tokens(self) -> int:
        """Per-iteration token-stream width (alias of n_compute_tokens;
        always ≤ the selected t_bucket)."""
        return self.n_compute_tokens

    @property
    def emitted_tokens(self) -> int:
        """Tokens this plan actually emits across all fused iterations."""
        if self.decode_steps > 1:
            return sum(len(c.positions) for c in self.prefills) \
                + sum(self.decode_iters)
        return self.n_compute_tokens

    def empty(self) -> bool:
        return not self.prefills and not self.decodes


@dataclass
class SchedulerConfig:
    block_size: int = 16
    token_budget: int = 256          # total compute tokens per step
    max_prefills: int = 4            # concurrent prefill chunks per step
    max_chunk: int = 128             # per-request chunk upper bound
    min_chunk: int = 16              # §5.1 lower bound
    max_decodes: int = 64
    decode_threshold: int = 8        # shrink chunks beyond this many decodes
    adaptive_chunking: bool = True
    max_running: int = 64
    # job-level admission arbitration (online session serving):
    #   "fcfs"             — submission order (the scripted-replay default)
    #   "fewest-remaining" — sessions with the fewest remaining tool calls
    #                        first (shortest-remaining-job-first over agent
    #                        jobs, the Continuum job scheduler policy);
    #                        requests without ``remaining_calls`` metadata
    #                        keep FCFS order among themselves, after those
    #                        that have it
    admission: str = "fcfs"
    # multi-token decode dispatch: on a decode-dominated step (no prefill
    # chunks, every running request decoding, no queued page ops) the
    # scheduler may fuse up to this many decode iterations into ONE
    # jitted engine call, amortizing the whole per-step control plane
    # (schedule + assemble + dispatch) k-fold.  1 = off (default; the
    # engine's single-step behaviour and counters are unchanged).  The
    # emitted k is floored to a power of two so the k-extended bucket
    # lattice stays small (jit variants ≤ log2(max_decode_steps) extra).
    max_decode_steps: int = 1
    # occupancy bucket lattices (wired from the engine by the server so
    # both sides agree; empty = scheduler leaves the choice to the
    # engine).  The §5.1 chunk decision above determines a step's token
    # count, so the scheduler is the natural place to pick its bucket.
    token_buckets: Tuple[int, ...] = ()
    page_buckets: Tuple[int, ...] = ()


class ChunkingScheduler:
    def __init__(self, cfg: SchedulerConfig, bm: BlockManager):
        self.cfg = cfg
        self.bm = bm
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.swaps_this_round = 0
        # multi-token gating hook: the server points this at the engine's
        # pending page-op queues — a queued COW copy or host-tier swap-in
        # must land in an ordinary k=1 step (the op indices target the
        # pool state at ONE step boundary, not k of them), so k-step
        # plans are only emitted when every queue is empty.
        self.pending_ops_fn = None
        # admission attempts and successes (always counted; the tracer
        # reads them per step), and the server's tracer (None: off)
        self.admit_tries = 0
        self.admitted = 0
        self.tracer = None

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def required_blocks(self, req: Request) -> int:
        """Pool blocks the request needs end-to-end (prompt + decode),
        before cache hits — the admission sizing and the ``required``
        field of a structured rejection."""
        bs = self.cfg.block_size
        return (req.target_len + bs - 1) // bs

    def _admit(self, req: Request, now: float) -> bool:
        """Match cache, allocate ALL blocks up front, build compute list.

        Full up-front allocation (prompt gaps + decode blocks) makes the
        loop deadlock-free: a running request never fails allocation.
        Admission defers while the pool can't supply the gap blocks.

        Cross-request prefix sharing happens in two layers here: full
        blocks of a previously served prefix are ordinary chain-hash hits
        (the prefill compute list simply starts after them), and a prefix
        ending mid-block is completed by a copy-on-write fork of the donor
        request's block, so only the post-divergence suffix is computed."""
        bs = self.cfg.block_size
        # pre-flight dedup hold (prefix-store analyze_batch): a follower
        # whose leading prompt block duplicates a batch-mate's waits for
        # the leader to finish prefilling, so the shared blocks are one
        # prefill + table hits instead of N concurrent identical ones.
        # The hold can never deadlock: a stuck leader is head-of-line
        # and the stall-rejection path terminates it, releasing us.
        leader = getattr(req, "_dedup_hold", None)
        if leader is not None:
            if not leader.terminal and \
                    leader.state in (RequestState.WAITING,
                                     RequestState.PREFILL):
                return False
            req._dedup_hold = None
        n_prompt_blocks = len(req.prompt_tokens) // bs
        salt = self.bm.request_salt(req.rid, req.hash_salt)
        hashes = getattr(req, "_prompt_hashes", None)
        if hashes is None:
            hashes = self.bm.block_hashes(req.prompt_tokens, salt=salt)
            req._prompt_hashes = hashes
        cks = None
        if salt == 0 and self.bm.store is not None and self.bm.store.enabled:
            cks = getattr(req, "_content_keys", None)
            if cks is None:
                cks = self.bm.content_keys(req.prompt_tokens)
                req._content_keys = cks
        m = self.bm.match(req.prompt_tokens, now, hashes=hashes,
                          content_keys=cks,
                          tenant=req.tenant)  # acquires hits
        total_blocks = (req.target_len + bs - 1) // bs
        needed = total_blocks - m.num_hits
        # pool-OOM fault site: an injected allocation failure takes the
        # exact deferral path a genuinely exhausted pool takes
        injected_oom = (needed > 0 and self.bm.faults is not None
                        and self.bm.faults.should_fire("admission_oom"))
        fresh = None if injected_oom else self.bm.allocate(needed, now)
        if fresh is None:
            # undo: drop the acquired hit references, stay waiting
            self.bm.release([s for s in m.hit_slots if s is not None], now)
            if injected_oom:
                self.bm.audit_after_fault()
            return False
        it = iter(fresh)
        req.block_slots = [
            (m.hit_slots[b] if b < n_prompt_blocks and m.hit_mask[b]
             else next(it)) for b in range(total_blocks)]
        # admission is now certain: realize any prefetched hits (count
        # them, drop their served resume pins).  Doing it here — not in
        # match() — keeps a deferred admission's rollback from stripping
        # the pins its retry depends on.
        self.bm.realize_prefetch(
            [s for s in m.hit_slots if s is not None], req.session_id)
        req.hit_mask = list(m.hit_mask)
        req.n_hit_blocks = m.num_hits
        req.n_total_blocks = max(n_prompt_blocks, 1)

        # host-tier hits (paper §7): swap the payload back into the freshly
        # allocated device slot instead of recomputing the block
        swapped = set()
        if self.bm.host_restore_active:
            for b in range(n_prompt_blocks):
                if b < len(m.host_hits) and m.host_hits[b] \
                        and not m.hit_mask[b] \
                        and self.bm.swap_in(hashes[b], req.block_slots[b],
                                            b, now):
                    # swap_in returning False = the host LRU dropped the
                    # key between match() and here (this admission's own
                    # evictions spill into the host tier); the block stays
                    # a gap and is recomputed losslessly
                    req.hit_mask[b] = True
                    req.n_hit_blocks += 1
                    swapped.add(b)
            req.n_swapped = len(swapped)
            self.swaps_this_round += len(swapped)

        # cross-request shared prefix (salt 0 = shared namespace): the trie
        # match length is recorded for metrics; if the prefix ends mid-block
        # and the donor's block is resident, fork it copy-on-write so the
        # partial block's positions drop out of the compute list too
        cow_block, cow_until = -1, -1
        if salt == 0 and self.bm.prefix_trie is not None:
            matched, donor = self.bm.match_shared_prefix(
                req.prompt_tokens, hashes)
            req.prefix_len = matched
            if donor is not None:
                b = matched // bs
                hit = b < n_prompt_blocks and req.hit_mask[b]
                if not hit and b not in swapped and b < len(req.block_slots):
                    self._prefer_donor_shard(req, b, donor, swapped,
                                             n_prompt_blocks)
                    self.bm.fork_into(donor, req.block_slots[b], now)
                    req.n_cow_forks += 1
                    cow_block, cow_until = b, matched

        # vectorized compute-list: a prompt position is cached when its
        # block is a device hit / swap-in, or it falls inside the COW'd
        # span of the forked partial block
        blk_cached = np.zeros((total_blocks,), bool)
        if n_prompt_blocks:
            blk_cached[:n_prompt_blocks] = req.hit_mask[:n_prompt_blocks]
        pos = np.arange(req.prompt_len, dtype=np.int32)
        cached = blk_cached[pos // bs]
        if cow_block >= 0:
            cached |= (pos // bs == cow_block) & (pos < cow_until)
        compute = pos[~cached]
        last = req.prompt_len - 1
        if compute.size == 0 or compute[-1] != last:
            # always recompute the sampling position
            compute = np.append(compute, np.int32(last))
        req.compute_list = compute
        req.n_prefill_compute = len(compute)
        req.compute_ptr = 0
        req.admitted_at = now
        req.state = RequestState.PREFILL
        req.reset_assembly_caches()
        return True

    # ------------------------------------------------------------------
    def _prefer_donor_shard(self, req: Request, b: int, donor: int,
                            swapped, n_prompt_blocks: int) -> None:
        """Shard-aware COW placement: the engine can only fold a fork into
        the jitted step when source and destination pages live on the SAME
        device shard (a cross-shard copy is a device-to-device transfer,
        routed through the eager fallback).  Both candidates are fresh
        uncommitted allocations, so swapping which logical block each one
        backs is free — do it when it co-locates the fork with its donor."""
        bm = self.bm
        if bm.n_shards <= 1:
            return
        ds = bm.shard_of(donor)
        if bm.shard_of(req.block_slots[b]) == ds:
            return
        for j, slot in enumerate(req.block_slots):
            if j == b or j in swapped:
                continue
            if j < n_prompt_blocks and req.hit_mask[j]:
                continue                       # hit slots are not ours to move
            if bm.shard_of(slot) == ds:
                req.block_slots[b], req.block_slots[j] = \
                    slot, req.block_slots[b]
                return

    # ------------------------------------------------------------------
    def _chunk_size(self, n_decodes: int, n_prefills: int) -> int:
        c = self.cfg
        if not c.adaptive_chunking:
            return c.max_chunk
        if n_decodes > c.decode_threshold:
            # §5.1: many decodes -> shrink prefill chunks, floor at min_chunk.
            # The shrink divides by the number of co-scheduled prefill
            # chunks too: TPOT is bounded by the step's *total* prefill
            # tokens, so k concurrent chunks each get a k-times-smaller
            # share of the same per-step prefill allowance.
            shrink = max(1, n_decodes - c.decode_threshold)
            size = c.max_chunk // ((1 + shrink // 4) * max(1, n_prefills))
            return max(c.min_chunk, size)
        return c.max_chunk

    # ------------------------------------------------------------------
    def schedule(self, now: float) -> StepPlan:
        plan = StepPlan()
        c = self.cfg
        self.swaps_this_round = 0

        # 1. admit waiting requests (defer on memory pressure).  Default is
        # arrival order; "fewest-remaining" re-ranks each round by the
        # session's remaining tool calls (job-level shortest-remaining-
        # first) — re-sorting per round keeps the rank current as sessions
        # progress, and the (arrival, rid) tie-break keeps it deterministic
        # saturated fast path: with max_running live requests no admission
        # can succeed, so skip the O(waiting) scan (and the
        # fewest-remaining re-sort) entirely — at thousands of queued
        # sessions the per-step admission cost must track admissions
        # made, not sessions resident (benchmarks/control_plane_stress.py
        # gates this).
        if len(self.running) < c.max_running and self.waiting:
            tr = self.tracer
            if tr is not None:
                tr.open("admit")
            still_waiting = []
            waiting = self.waiting
            if c.admission == "fewest-remaining" and len(waiting) > 1:
                waiting = sorted(
                    waiting, key=lambda r: (
                        r.remaining_calls if r.remaining_calls is not None
                        else (1 << 30), r.arrival, r.rid))
            for i, req in enumerate(waiting):
                if len(self.running) >= c.max_running:
                    still_waiting.extend(waiting[i:])
                    break
                if req.arrival <= now:
                    self.admit_tries += 1
                    if self._admit(req, now):
                        self.admitted += 1
                        self.running.append(req)
                        continue
                still_waiting.append(req)
            self.waiting = still_waiting
            if tr is not None:
                tr.close()

        # 2. decodes first (memory-bound, latency-critical)
        decodes = [r for r in self.running if r.state == RequestState.DECODE]
        for req in decodes[:c.max_decodes]:
            plan.decodes.append(req)

        # 3. prefill chunks under the remaining token budget
        budget = c.token_budget - len(plan.decodes)
        prefills = [r for r in self.running if r.state == RequestState.PREFILL]
        chunk = self._chunk_size(len(plan.decodes),
                                 min(len(prefills), c.max_prefills))
        for req in prefills[:c.max_prefills]:
            if budget <= 0:
                break
            take = min(chunk, budget,
                       len(req.compute_list) - req.compute_ptr)
            if take <= 0:
                continue
            want = req.compute_list[req.compute_ptr:req.compute_ptr + take]
            req.compute_ptr += len(want)
            budget -= len(want)
            plan.prefills.append(PrefillChunk(
                req=req, positions=want,
                completes_prefill=req.prefill_done))

        self._select_decode_steps(plan)
        self._select_buckets(plan)
        return plan

    def _select_decode_steps(self, plan: StepPlan) -> None:
        """Multi-token decode dispatch (§5.1 decode-dominated detection).

        A step is decode-dominated when the chunk decision produced no
        prefill chunk AND every running request is decoding — i.e. no
        prefill work is admissible at all, so the next k steps are known
        to be pure decode.  Fusing k decode iterations into one jitted
        call then amortizes the whole per-step control plane; k is capped
        by ``max_decode_steps``, bounded by the longest remaining output
        (no point tracing a k nothing can consume), and floored to a
        power of two so the k-extended jit lattice stays small.

        k stays 1 whenever any page op is queued (block-manager COW
        copies or the engine's pending copy/swap queues via
        ``pending_ops_fn``): queued ops fold into the next step against
        ONE step boundary's pool state, and a request with a pending
        swap-in or fork must never ride a k-step plan."""
        c = self.cfg
        if (c.max_decode_steps <= 1 or plan.prefills or not plan.decodes):
            return
        if any(r.state is not RequestState.DECODE for r in self.running):
            return                         # prefill work still admissible
        if self.bm.pending_copies or (
                self.pending_ops_fn is not None and self.pending_ops_fn()):
            return
        rem = max(len(r.output_script) - len(r.generated)
                  for r in plan.decodes)
        k = max(1, min(c.max_decode_steps, rem))
        k = 1 << (k.bit_length() - 1)      # floor to a power of two
        if k <= 1:
            return
        plan.decode_steps = k
        plan.decode_iters = [
            min(k, len(r.output_script) - len(r.generated))
            for r in plan.decodes]

    def _select_buckets(self, plan: StepPlan) -> None:
        """Occupancy bucket selection (fused engine layout): smallest
        lattice entries covering this step's compute tokens (a direct
        function of the §5.1 chunk decision) and its deepest page table."""
        c = self.cfg
        if c.token_buckets and not plan.empty():
            need = plan.n_compute_tokens
            plan.t_bucket = next((b for b in c.token_buckets if b >= need),
                                 c.token_buckets[-1])
        if c.page_buckets and not plan.empty():
            bs = c.block_size
            need = 1
            for ch in plan.prefills:
                need = max(need, -(-(int(ch.positions[-1]) + 1) // bs))
            for req in plan.decodes:
                # a k-step plan's last iteration reads k-1 positions past
                # the current context — the page bucket must cover it
                ctx = req.prompt_len + len(req.generated) \
                    + plan.decode_steps - 1
                need = max(need, -(-ctx // bs))
            plan.np_bucket = next((b for b in c.page_buckets if b >= need),
                                  c.page_buckets[-1])

    # ------------------------------------------------------------------
    def finish(self, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.finished_at = now
        self.running.remove(req)
        slots = [s for s in req.block_slots if s is not None]
        self.bm.release(slots, now)

    def cancel(self, req: Request, now: float) -> bool:
        """Abort a request (online frontend).  Waiting requests just leave
        the queue (no blocks were allocated); running ones release every
        block reference immediately — refcounts return to their pre-
        admission baseline, uncommitted blocks go back to the free list.
        A step already dispatched with this request keeps executing (its
        KV writes land in pages that are now reallocatable — any later
        writer is ordered after it by the pipeline's data dependency) but
        the request never enters another plan.  Returns False when the
        request already finished or was never submitted."""
        return self.remove(req, now, RequestState.CANCELLED)

    def remove(self, req: Request, now: float,
               state: RequestState) -> bool:
        """Terminal removal shared by cancellation and the per-request
        fault domain: take the request out of scheduling, release every
        block reference it owns, cancel any still-queued copy-on-write
        copies INTO its pages (their dst is about to be reallocatable —
        draining them later would scatter into someone else's block) and
        land it in ``state`` (CANCELLED / FAILED / REJECTED)."""
        if req.terminal:
            return False
        if req in self.waiting:
            self.waiting.remove(req)
            req.state = state
            req.finished_at = now
            return True
        if req not in self.running:
            return False
        self.running.remove(req)
        slots = [s for s in req.block_slots if s is not None]
        self.bm.drop_copies_to(slots, now)
        self.bm.release(slots, now)
        req.state = state
        req.finished_at = now
        return True
